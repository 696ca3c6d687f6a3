"""The port's LPIPS-VGG16 (models/lpips.py) and metrics harness
(eval/metrics.py) against sdpgs_tpu's, on the CPU, on random VGG parameters
written to the .npz layout of tools/convert_lpips.py (nothing is
downloaded): LPIPS with tiny stages and with the full VGG16 at 32x32 to 1e-4
relative, 0 for an image against itself; make_lpips_fn with and without a
file; evaluate_dirs with and without DTU masks (the skimage SSIM), its
summaries and per-view scores to 1e-5; aggregate_results's file equal."""

import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import sdpgs_tpu.models.lpips as jlpips_mod
from sdpgs_torch.eval import metrics as tmetrics
from sdpgs_torch.models.lpips import VGG16_STAGES, LPIPS
from sdpgs_tpu.eval import metrics as jmetrics
from test_lpips import random_lpips_params
from torch_threads import few_threads  # noqa: F401  (autouse)

TINY = [(8, 2), (16, 2), (16, 3)]
LPIPS_RTOL = 1e-4
METRIC_TOL = 1e-5


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """Full-width VGG16 + heads, random, in convert_lpips.py's layout (~59 MB)."""
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg_random.npz"
    np.savez(path, **random_lpips_params(np.random.default_rng(1)))
    return path


def jax_lpips(params, stages, img1, img2, monkeypatch):
    """JAX's LPIPS reads its stage layout from a module global."""
    monkeypatch.setattr(jlpips_mod, "VGG16_STAGES", stages)
    return float(jlpips_mod.LPIPS(params)(img1, img2))


def test_tiny_lpips_matches_jax(rng, tmp_path, monkeypatch):
    params = random_lpips_params(rng, TINY)
    np.savez(tmp_path / "tiny.npz", **params)
    img1, img2 = (rng.uniform(size=(3, 32, 32)).astype(np.float32) for _ in range(2))
    model = LPIPS.load(tmp_path / "tiny.npz", stages=TINY, device="cpu")
    got = float(model(torch.from_numpy(img1), torch.from_numpy(img2)))
    assert got == pytest.approx(jax_lpips(params, TINY, img1, img2, monkeypatch), rel=LPIPS_RTOL)
    assert float(model(torch.from_numpy(img1), torch.from_numpy(img1))) == 0.0
    assert [tuple(f.shape) for f in model.features(torch.from_numpy(img1))] == \
        [(1, 8, 32, 32), (1, 16, 16, 16), (1, 16, 8, 8)]


def test_vgg16_lpips_matches_jax(vgg_npz, rng):
    model = LPIPS.load(vgg_npz, device="cpu")
    assert model.stages == VGG16_STAGES and model.conv4_2_w.device.type == "cpu"
    params = dict(np.load(vgg_npz))
    jmodel = jlpips_mod.LPIPS(params)
    img1, img2 = (rng.uniform(size=(3, 32, 32)).astype(np.float32) for _ in range(2))
    got = float(model(torch.from_numpy(img1), torch.from_numpy(img2)))
    ref = float(jmodel(img1, img2))
    assert got > 0 and got == pytest.approx(ref, rel=LPIPS_RTOL), (got, ref)
    assert float(model(torch.from_numpy(img2), torch.from_numpy(img2))) == 0.0


def test_make_lpips_fn(vgg_npz, rng, tmp_path):
    for missing in (None, str(tmp_path / "missing.npz")):
        assert tmetrics.make_lpips_fn(missing, device="cpu")(None, None) is None
    fn = tmetrics.make_lpips_fn(str(vgg_npz), device="cpu")
    a, b = (rng.uniform(size=(3, 32, 32)).astype(np.float32) for _ in range(2))
    got = fn(a, b)
    model = LPIPS.load(vgg_npz, device="cpu")
    assert isinstance(got, float) and got == float(model(torch.from_numpy(a), torch.from_numpy(b)))
    assert fn(torch.from_numpy(a), torch.from_numpy(a)) == 0.0


def test_make_lpips_fn_needs_cuda_without_a_device(vgg_npz):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for weights in (str(vgg_npz), None):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tmetrics.make_lpips_fn(weights)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmetrics.evaluate_dirs("renders", "gt")


def write_pairs(root, rng, n=3, H=32, W=32, masks=False):
    """renders/ and gt/ PNGs that differ by noise (one pair identical) and,
    with ``masks``, DTU object masks (one view without a mask file)."""
    for d in ("renders", "gt") + (("masks",) if masks else ()):
        (root / d).mkdir(parents=True)
    for i in range(n):
        gt = rng.uniform(size=(H, W, 3))
        img = gt if i == 0 else np.clip(gt + rng.normal(0, 0.05 * i, gt.shape), 0, 1)
        Image.fromarray((gt * 255).astype(np.uint8)).save(root / "gt" / f"{i:05d}.png")
        Image.fromarray((img * 255).astype(np.uint8)).save(root / "renders" / f"{i:05d}.png")
        if masks and i < n - 1:
            m = np.zeros((H, W), np.uint8)
            m[4:20, 6 + i:28] = 255
            Image.fromarray(m).save(root / "masks" / f"{i:05d}.png")


def same_scores(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            same_scores(got[k], ref[k])
        elif ref[k] is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(ref[k], rel=METRIC_TOL, abs=METRIC_TOL), k


@pytest.mark.parametrize("masks", [False, True])
def test_evaluate_dirs_matches_jax(vgg_npz, rng, tmp_path, masks):
    write_pairs(tmp_path, rng, masks=masks)
    kw = dict(masks_dir=tmp_path / "masks" if masks else None, lpips_weights=str(vgg_npz))
    got = tmetrics.evaluate_dirs(tmp_path / "renders", tmp_path / "gt", device="cpu", **kw)
    ref = jmetrics.evaluate_dirs(tmp_path / "renders", tmp_path / "gt", **kw)
    same_scores(got, ref)
    assert len(got["per_view"]["LPIPS"]) == 3 and got["per_view"]["LPIPS"]["00000.png"] == 0.0
    assert (got["summary"]["SSIM_sk"] is not None) == masks
    assert got["per_view"]["PSNR"]["00000.png"] > 100
    bare = tmetrics.evaluate_dirs(tmp_path / "renders", tmp_path / "gt",
                                  masks_dir=kw["masks_dir"], device="cpu")
    assert bare["summary"]["LPIPS"] is None and bare["summary"]["AVGE"] is None
    assert bare["summary"]["PSNR"] == got["summary"]["PSNR"]


def test_model_paths_and_aggregate_match_jax(vgg_npz, rng, tmp_path):
    for scene in ("fern", "horns"):
        for method in ("ours_10", "ours_30"):
            write_pairs(tmp_path / "t" / scene / "test" / method, rng)
    (tmp_path / "t" / "empty").mkdir()
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    scenes = ["fern", "horns", "empty"]
    tmetrics.evaluate_model_paths([str(tmp_path / "t" / s) for s in scenes],
                                  lpips_weights=str(vgg_npz), device="cpu")
    jmetrics.evaluate_model_paths([str(tmp_path / "j" / s) for s in scenes],
                                  lpips_weights=str(vgg_npz))
    for scene in ("fern", "horns"):
        for f in ("results.json", "per_view.json"):
            same_scores(json.loads((tmp_path / "t" / scene / f).read_text()),
                        json.loads((tmp_path / "j" / scene / f).read_text()))
    assert not (tmp_path / "t" / "empty" / "results.json").exists()
    # the aggregate over the same results files: equal files
    shutil.copy(tmp_path / "j" / "fern" / "results.json", tmp_path / "t" / "fern" / "results.json")
    shutil.copy(tmp_path / "j" / "horns" / "results.json",
                tmp_path / "t" / "horns" / "results.json")
    summary = tmetrics.aggregate_results(tmp_path / "t")
    assert summary == jmetrics.aggregate_results(tmp_path / "j")
    assert (tmp_path / "t" / "results_all.json").read_bytes() == \
        (tmp_path / "j" / "results_all.json").read_bytes()
    assert set(summary) == {"ours_10", "ours_30"} and "LPIPS" in summary["ours_10"]
