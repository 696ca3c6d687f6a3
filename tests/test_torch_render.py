"""The port's render path end to end on the CPU (the kernels' plain
versions) against sdpgs_tpu: render / render_for_depth / render_for_opa on
a cloud carried across by from_numpy and by PLY, rasterize against the
port's own golden rasterize_naive, render_set's file layout, the import
boundary, and the entry points' refusal to fall back to the CPU."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu import render as jrender
from sdpgs_tpu.config import RasterizeConfig as JConfig
from sdpgs_tpu.core.camera import Camera as JCamera
from sdpgs_tpu.data.ply import save_gaussians_ply as j_save_ply
from sdpgs_torch import _kernels, default_device
from sdpgs_torch import render as trender
from sdpgs_torch.cli.render_cli import render_set
from sdpgs_torch.config import RasterizeConfig as TConfig
from sdpgs_torch.config import TrainConfig
from sdpgs_torch.core.camera import Camera as TCamera
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.core.transforms import build_covariance_3d, normalize_quat
from sdpgs_torch.data.camera_utils import LoadedCamera
from sdpgs_torch.data.ply import load_gaussians_ply
from sdpgs_torch.ops.rasterize.rasterizer import rasterize, rasterize_naive
from sdpgs_torch.train.state import TrainState
from sdpgs_torch.train.step import ViewBatch, make_train_step
from test_torch_core import jax_gaussians, random_arrays

REPO = Path(__file__).resolve().parent.parent
CAM = dict(R=np.eye(3), T=np.array([0.1, -0.05, 0.0]), fovx=0.9, fovy=0.7,
           width=72, height=56)
CONFIGS = {
    "roomy": dict(tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32),
    "tight": dict(tile=16, max_per_tile=32, max_tiles_per_gaussian=2, chunk=32),
}
JAX_PATHS = dict(use_pallas=False, use_rank_kernel=False)


def assert_outputs_match(got, ref, expect_drops=None):
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.feature.numpy(), np.asarray(ref.feature), atol=2e-4, rtol=0)
    for name in ("radii", "visibility", "overflow", "clipped", "slab"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    if expect_drops is not None:
        assert (int(got.overflow) + int(got.clipped) > 0) == expect_drops


def jax_render(fn, arrays, cfg_kw, **kw):
    call = jax.jit(lambda g, bg: fn(JCamera.create(**CAM), g, JConfig(**cfg_kw, **JAX_PATHS),
                                    bg, 3, **kw))
    return call(jax_gaussians(arrays), jnp.array([0.1, 0.2, 0.3]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_matches_jax(rng, name):
    arrays = random_arrays(rng, P=256, n=220)
    ref = jax_render(jrender.render, arrays, CONFIGS[name])
    g = Gaussians.from_numpy(arrays, device="cpu")
    got = trender.render(TCamera.create(**CAM, device="cpu"), g, TConfig(**CONFIGS[name]),
                         np.array([0.1, 0.2, 0.3]), 3, device="cpu")
    assert float(got.alpha.mean()) > 0.05
    assert_outputs_match(got, ref, expect_drops=(name == "tight"))


def test_render_options_match_jax(rng):
    arrays = random_arrays(rng, P=256, n=220)
    over_c = rng.uniform(size=(256, 3)).astype(np.float32)
    over_l = rng.normal(size=(256, 3)).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, size=(256, 1)).astype(np.float32)
    ref = jax_render(jrender.render, arrays, CONFIGS["roomy"], scaling_modifier=1.3,
                     override_color=jnp.asarray(over_c), override_language=jnp.asarray(over_l),
                     confidence=jnp.asarray(conf))
    got = trender.render(TCamera.create(**CAM, device="cpu"),
                         Gaussians.from_numpy(arrays, device="cpu"),
                         TConfig(**CONFIGS["roomy"]), np.array([0.1, 0.2, 0.3]), 3,
                         scaling_modifier=1.3, override_color=torch.from_numpy(over_c),
                         override_language=torch.from_numpy(over_l),
                         confidence=torch.from_numpy(conf), device="cpu")
    assert_outputs_match(got, ref)


@pytest.mark.parametrize("variant", ["render_for_depth", "render_for_opa"])
def test_render_variants_match_jax(rng, variant):
    arrays = random_arrays(rng, P=256, n=220)
    ref = jax_render(getattr(jrender, variant), arrays, CONFIGS["roomy"])
    got = getattr(trender, variant)(TCamera.create(**CAM, device="cpu"),
                                    Gaussians.from_numpy(arrays, device="cpu"),
                                    TConfig(**CONFIGS["roomy"]), np.array([0.1, 0.2, 0.3]),
                                    3, device="cpu")
    assert_outputs_match(got, ref)


def test_render_of_jax_ply_matches_jax(rng, tmp_path):
    arrays = random_arrays(rng, P=256, n=220)
    j_save_ply(tmp_path / "point_cloud.ply", jax_gaussians(arrays))
    g = load_gaussians_ply(tmp_path / "point_cloud.ply", 256, 3, device="cpu")
    ref = jax_render(jrender.render, arrays, CONFIGS["roomy"])
    got = trender.render(TCamera.create(**CAM, device="cpu"), g, TConfig(**CONFIGS["roomy"]),
                         torch.tensor([0.1, 0.2, 0.3]), 3, device="cpu")
    assert_outputs_match(got, ref)


def test_rasterize_matches_naive(rng):
    """The tiled path against the port's untiled golden (cov3d preprocess)."""
    n = 200
    xyz = torch.tensor(rng.normal(size=(n, 3)) * [1.0, 0.8, 0.5] + [0, 0, 4.0],
                       dtype=torch.float32)
    scale = torch.tensor(np.abs(rng.normal(size=(n, 3))) * 0.06 + 0.02, dtype=torch.float32)
    quat = normalize_quat(torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32))
    args = (xyz, build_covariance_3d(scale, quat),
            torch.tensor(rng.uniform(0.2, 0.95, size=n), dtype=torch.float32),
            torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32),
            torch.ones(n), TCamera.create(R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.75,
                                          width=80, height=64, device="cpu"),
            torch.zeros(3), TConfig(tile=16, max_per_tile=128, max_tiles_per_gaussian=32,
                                    chunk=32))
    out_t = rasterize(*args, device="cpu")
    out_n = rasterize_naive(*args, device="cpu")
    assert int(out_t.overflow) == 0 and int(out_t.clipped) == 0
    np.testing.assert_allclose(out_t.color.numpy(), out_n.color.numpy(), atol=2e-5)
    np.testing.assert_allclose(out_t.depth.numpy(), out_n.depth.numpy(), atol=2e-4)
    np.testing.assert_allclose(out_t.alpha.numpy(), out_n.alpha.numpy(), atol=2e-5)
    np.testing.assert_allclose(out_t.feature.numpy(), out_n.feature.numpy(), atol=2e-4)
    np.testing.assert_array_equal(out_t.radii.numpy(), out_n.radii.numpy())


def test_render_set_layout(rng, tmp_path):
    g = Gaussians.from_numpy(random_arrays(rng, P=64, n=40), device="cpu")
    cams = [LoadedCamera(camera=TCamera.create(R=np.eye(3), T=np.array([0.1 * i, 0, 0]),
                                               fovx=0.9, fovy=0.7, width=48, height=32,
                                               device="cpu"),
                         R=np.eye(3), T=np.array([0.1 * i, 0, 0]), fovx=0.9, fovy=0.7,
                         image=rng.uniform(size=(3, 32, 48)).astype(np.float32),
                         image_name=f"v{i}")
            for i in range(2)]
    render_set(tmp_path, "test", 7, cams, g, TConfig(**CONFIGS["roomy"]), np.zeros(3), 3,
               device="cpu")
    base = tmp_path / "test" / "ours_7"
    for i in range(2):
        for f in (f"renders/{i:05d}.png", f"gt/{i:05d}.png", f"depth/{i:05d}.png",
                  f"depth/depth_{i:05d}.npy", f"feature/{i:05d}.png"):
            assert (base / f).exists(), f
    d = np.load(base / "depth" / "depth_00000.npy")
    assert d.shape == (32, 48) and np.isfinite(d).all()


FORBIDDEN = ("jax", "jaxlib", "flax", "sdpgs_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "sdpgs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): r for f in files for r in _imported_roots(f)
           if r in FORBIDDEN}
    assert not bad


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.launch("binning", "sdpgs_bin_table")
    assert _kernels.LAUNCHES["binning"] == 0 and not (tmp_path / "kernels").exists()


@pytest.mark.parametrize("bad,match", [
    ("dtype", "expected torch.int32"), ("shape", "expected shape"),
    ("strided", "contiguous"), ("grad", "requires grad"), ("cpu", "CUDA tensor"),
])
def test_kernel_input_checks(bad, match):
    """What a wrapper refuses before it launches; a CPU tensor is refused
    last, so each other case fails for its own reason on any host."""
    t = torch.zeros((3, 4)).T if bad == "strided" else torch.zeros((4, 3))
    t.requires_grad_(bad == "grad")
    dtype = torch.int32 if bad == "dtype" else torch.float32
    shape = (3, 4) if bad == "shape" else (4, 3)
    with pytest.raises(ValueError, match=match):
        _kernels.check(t, "x", dtype, shape)


def test_entry_points_refuse_cpu_without_request(rng, tmp_path, monkeypatch):
    """With no CUDA device, an entry point called without ``device`` raises
    instead of quietly running on the CPU."""
    arrays = random_arrays(rng, P=32, n=20)
    ply = tmp_path / "g.ply"
    j_save_ply(ply, jax_gaussians(arrays))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Gaussians.from_numpy(arrays, device="cpu")
    cam = TCamera.create(**CAM, device="cpu")
    cfg = TConfig(**CONFIGS["roomy"])
    state = TrainState.create(Gaussians.from_numpy(arrays, device="cpu"), device="cpu")
    batch = ViewBatch(cameras=[cam], image=torch.zeros((1, 3, 56, 72)),
                      depth_mono=torch.ones((1, 56, 72)), feature=torch.zeros((1, 3, 56, 72)),
                      seg_map=torch.zeros((1, 56, 72), dtype=torch.int32))
    step = make_train_step(TrainConfig(raster=cfg), 3)
    calls = [
        lambda: default_device(),
        lambda: load_gaussians_ply(ply, 32),
        lambda: Gaussians.from_numpy(arrays),
        lambda: TCamera.create(**CAM),
        lambda: trender.render(cam, g, cfg, np.zeros(3), 3),
        lambda: render_set(tmp_path, "x", 0, [], g, cfg, np.zeros(3), 3),
        lambda: TrainState.create(g),
        lambda: step(state, batch, torch.ones((4, 3)), torch.zeros(3), 1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert default_device("cpu") == torch.device("cpu")
