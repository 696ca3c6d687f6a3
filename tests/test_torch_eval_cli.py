"""The port's render and metrics CLIs (cli/render_cli.main,
cli/metrics_cli.main) against sdpgs_tpu's, on the CPU, over one model
directory: the COLMAP tree of test_scene.py (with LLFF poses a spiral can
follow), a ``cfg.json`` and one PLY snapshot.

Both render CLIs run with ``--spiral --video`` into copies of the directory;
every file one writes the other writes too, PNGs agree within 1 LSB at no
more than 0.1% of their values and the depth ``.npy`` to 1e-4. JAX's
``render`` runs under ``jax.jit`` here (eager it takes ~0.5 s a view on this
CPU; the jitted function is the same). Both metrics CLIs then score one
rendered directory: the same JSON keys, values to 1e-5; the port's again
with a random VGG16 .npz.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import sdpgs_tpu.render as jrender
from sdpgs_torch.cli import metrics_cli as tmetrics_cli
from sdpgs_torch.cli import render_cli as trender_cli
from sdpgs_torch.config import RasterizeConfig, TrainConfig, save_config
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.data.ply import save_gaussians_ply
from sdpgs_torch.eval.metrics import load_image
from sdpgs_torch.models.lpips import LPIPS
from sdpgs_tpu.cli import metrics_cli as jmetrics_cli
from sdpgs_tpu.cli import render_cli as jrender_cli
from test_lpips import random_lpips_params
from test_scene import make_colmap_scene
from test_torch_core import random_arrays

ITERATION = 7
LSB_SHARE = 1e-3      # PNG values more than 0 LSB apart: at most this share
DEPTH_TOL = 1e-4
METRIC_TOL = 1e-5


def write_model(tmp_path):
    """A scene tree and a model directory holding cfg.json and a PLY."""
    root = tmp_path / "llff_scene"
    root.mkdir()
    make_colmap_scene(root)
    # LLFF's layout: the c2w columns (y, x, -z, centre) of cameras looking
    # down +z, then (H, W, focal), then the near and far bounds
    rng = np.random.default_rng(3)
    pb = np.zeros((9, 17))
    for i in range(9):
        centre = np.array([0.2 * i - 0.8, 0.1 * rng.normal(), 0.05 * rng.normal()])
        cols = [np.eye(3)[:, 1:2], np.eye(3)[:, 0:1], -np.eye(3)[:, 2:3], centre[:, None],
                np.array([[48.0], [64.0], [60.0]])]
        pb[i, :15] = np.concatenate(cols, 1).reshape(-1)
    pb[:, 15:] = (1.0, 10.0)
    np.save(root / "poses_bounds.npy", pb)

    model = tmp_path / "model"
    cfg = TrainConfig(raster=RasterizeConfig(tile=16, max_per_tile=64, max_tiles_per_gaussian=8,
                                             use_pallas=False, use_rank_kernel=False))
    m = cfg.model
    m.source_path, m.model_path = str(root), str(model)
    m.resolution, m.nviews, m.capacity = 2, 3, 512
    m.language_features_name = "features_dim3"
    ply = model / "point_cloud" / f"iteration_{ITERATION}" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    save_config(cfg, model / "cfg.json")
    arrays = random_arrays(np.random.default_rng(4), P=512, n=300)
    arrays["xyz"][:300] *= [2.0, 2.0, 1.0]
    save_gaussians_ply(ply, Gaussians.from_numpy(arrays, device="cpu"))
    return model


def png_files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.suffix in (".png", ".npy"))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("eval_cli")
    model = write_model(tmp_path)
    shutil.copytree(model, tmp_path / "jmodel")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "render", jax.jit(jrender.render, static_argnums=(2, 4)))
        jrender_cli.main(["-m", str(tmp_path / "jmodel"), "--spiral", "--video"])
    trender_cli.main(["-m", str(model), "--spiral", "--video"], device="cpu")
    return model, tmp_path / "jmodel"


def test_render_cli_matches_jax(rendered):
    model, jmodel = rendered
    files = png_files(model)
    assert files == png_files(jmodel)
    sets = {f.parts[0] for f in files}
    assert sets == {"train", "test", "video", "video_spiral"}, sets
    n_spiral = len(list((model / "video_spiral" / f"ours_{ITERATION}").iterdir()))
    assert n_spiral == 180 and len(list((model / "video" / f"ours_{ITERATION}").iterdir())) == 180
    assert len(list((model / "train" / f"ours_{ITERATION}" / "renders").iterdir())) == 3
    worst, brightness = 0.0, []
    for f in files:
        if f.suffix == ".npy":
            np.testing.assert_allclose(np.load(model / f), np.load(jmodel / f),
                                       atol=DEPTH_TOL, rtol=DEPTH_TOL, err_msg=str(f))
            continue
        a = np.asarray(Image.open(model / f), np.int16)
        b = np.asarray(Image.open(jmodel / f), np.int16)
        assert a.shape == b.shape, f
        diff = np.abs(a - b)
        assert diff.max() <= 1, f
        worst = max(worst, float((diff > 0).mean()))
        if f.parts[0] == "video_spiral":
            brightness.append(a.mean())
    assert worst <= LSB_SHARE, worst
    assert max(brightness) > 1.0, "every spiral frame is black"


def test_render_cli_refuses_without_a_device(rendered):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        trender_cli.main(["-m", str(rendered[0]), "--skip_train", "--skip_test"])


def same_json(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same_json(a[k], b[k])
    elif a is not None:
        assert a == pytest.approx(b, rel=METRIC_TOL, abs=METRIC_TOL)


def read_results(model):
    return {f: json.loads((model / f).read_text()) for f in ("results.json", "per_view.json")
            } | {"all": json.loads((model.parent / "results_all.json").read_text())}


def test_metrics_cli_matches_jax(rendered, tmp_path):
    """Both CLIs over the port's renders (no LPIPS weights: JAX's eager VGG16
    would take most of this file's time; test_torch_lpips.py holds the
    harness's LPIPS to JAX's), then the port's with a random VGG16 .npz,
    whose per-view LPIPS must be the network's on those PNGs."""
    model, _ = rendered
    argv = ["-m", str(model), "--aggregate", str(model.parent)]
    jmetrics_cli.main(argv)
    ref = read_results(model)
    tmetrics_cli.main(argv, device="cpu")
    got = read_results(model)
    method = f"ours_{ITERATION}"
    assert got["results.json"][method]["LPIPS"] is None
    same_json(got, ref)

    npz = tmp_path / "lpips_vgg_random.npz"
    np.savez(npz, **random_lpips_params(np.random.default_rng(2)))
    tmetrics_cli.main(argv + ["--lpips_weights", str(npz)], device="cpu")
    scored = read_results(model)
    lpips = scored["per_view.json"][method]["LPIPS"]
    net = LPIPS.load(npz, device="cpu")
    base = model / "test" / method
    assert sorted(lpips) == sorted(p.name for p in (base / "renders").iterdir()) and lpips
    for name, v in lpips.items():
        img, gt = (torch.from_numpy(load_image(base / d / name)) for d in ("renders", "gt"))
        assert v == float(net(img, gt)) and v > 0
    assert scored["results.json"][method]["LPIPS"] == pytest.approx(np.mean(list(lpips.values())))
    assert scored["all"][method]["LPIPS"] == scored["results.json"][method]["LPIPS"]
    same_json({k: v for k, v in scored["results.json"][method].items() if k in ("PSNR", "SSIM")},
              {k: v for k, v in ref["results.json"][method].items() if k in ("PSNR", "SSIM")})
