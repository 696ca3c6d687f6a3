"""The port's plain train step against sdpgs_tpu's, on the CPU (the plain
versions of K1-K5).

One step from the same state: a JAX TrainState that has taken 3 steps
(so Adam's moments are non-zero: from zero moments at eps 1e-15 every
parameter moves by +-lr whatever its gradient) is carried across with
from_numpy, and both packages take one step at V = 1 and 2 views and SH
degree 3 and 0. The JAX gradients are read back from its Adam moments,
g = (mu_new - 0.9 mu_old) / 0.1 (exact to float32 rounding of mu).
Tolerances: gradients within 1e-4 of each field's largest gradient (the
same formulas in float32, summed in another order); parameters within
1e-5 absolute; moments and statistics within 1e-4 of the field's largest;
loss, L1 and PSNR to 1e-5 relative; the capacity telemetry and the alive
count exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu import config as jconfig
from sdpgs_tpu.core.camera import Camera as JCamera
from sdpgs_tpu.train.state import TrainState as JState
from sdpgs_tpu.train.step import ViewBatch as JBatch
from sdpgs_tpu.train.step import make_train_step as j_make_train_step
from sdpgs_torch import config as tconfig
from sdpgs_torch.core.camera import Camera as TCamera
from sdpgs_torch.core.gaussians import create_from_points
from sdpgs_torch.opt.adam import TRAINABLE
from sdpgs_torch.render import render
from sdpgs_torch.train.state import STAT_FIELDS, TrainState
from sdpgs_torch.train.step import ViewBatch, loss_and_grads, make_train_step
from test_torch_adam import jax_state_arrays
from test_torch_core import jax_gaussians, random_arrays
from torch_threads import few_threads  # noqa: F401  (autouse)

RASTER = dict(tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32)
W, H, S = 72, 56, 4
CAM = dict(R=np.eye(3), fovx=0.9, fovy=0.7, width=W, height=H)
TRANSLATIONS = [np.array([0.1, -0.05, 0.0]), np.array([-0.12, 0.04, 0.02])]


def jax_cfg():
    cfg = jconfig.TrainConfig()
    cfg.raster = jconfig.RasterizeConfig(**RASTER, use_pallas=False, use_rank_kernel=False)
    return cfg


def torch_cfg():
    return tconfig.TrainConfig(raster=tconfig.RasterizeConfig(**RASTER))


@pytest.fixture(scope="module")
def scene():
    """Inputs, and the JAX state after 3 steps (as numpy, since the JAX step
    donates its state) with its step functions by SH degree."""
    rng = np.random.default_rng(0)
    V = len(TRANSLATIONS)
    data = dict(
        arrays=random_arrays(rng, P=256, n=220),
        image=rng.uniform(size=(V, 3, H, W)).astype(np.float32),
        mono=rng.uniform(1, 8, size=(V, H, W)).astype(np.float32),
        feature=rng.normal(size=(V, 3, H, W)).astype(np.float32),
        seg=rng.integers(0, S, size=(V, H, W)).astype(np.int32),
        protos=rng.normal(size=(S, 3)).astype(np.float32),
        bg=np.array([0.1, 0.2, 0.3], np.float32),
    )
    steps = {3: j_make_train_step(jax_cfg(), 3)}
    js = JState.create(jax_gaussians(data["arrays"]))
    for _ in range(3):
        js, _ = steps[3](js, jax_batch(data, V), jnp.asarray(data["protos"]),
                         jnp.asarray(data["bg"]), jnp.float32(1.0))
    data["jax_state"] = jax.tree_util.tree_map(np.array, js)
    data["jax_steps"] = steps
    return data


def jax_batch(data, V):
    cams = [JCamera.create(T=TRANSLATIONS[i], **CAM) for i in range(V)]
    return JBatch(camera=jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams),
                  image=jnp.asarray(data["image"][:V]), depth_mono=jnp.asarray(data["mono"][:V]),
                  feature=jnp.asarray(data["feature"][:V]), seg_map=jnp.asarray(data["seg"][:V]))


def torch_batch(data, V):
    return ViewBatch(cameras=[TCamera.create(T=TRANSLATIONS[i], **CAM, device="cpu")
                              for i in range(V)],
                     image=torch.from_numpy(data["image"][:V]),
                     depth_mono=torch.from_numpy(data["mono"][:V]),
                     feature=torch.from_numpy(data["feature"][:V]),
                     seg_map=torch.from_numpy(data["seg"][:V]))


def rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("deg", [3, 0])
@pytest.mark.parametrize("V", [1, 2])
def test_one_step_matches_jax(scene, V, deg):
    if deg not in scene["jax_steps"]:
        scene["jax_steps"][deg] = j_make_train_step(jax_cfg(), deg)
    js = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), scene["jax_state"])
    before = jax_state_arrays(js)
    js, jm = scene["jax_steps"][deg](js, jax_batch(scene, V), jnp.asarray(scene["protos"]),
                                     jnp.asarray(scene["bg"]), jnp.float32(1.0))
    after = jax_state_arrays(js)

    state = TrainState.from_numpy(before, device="cpu")
    assert state.step == 3 and state.opt_state.step == 3
    grads = loss_and_grads(state, torch_batch(scene, V), torch.from_numpy(scene["protos"]),
                           torch.from_numpy(scene["bg"]), torch_cfg(), deg,
                           torch.device("cpu"))
    state, tm = make_train_step(torch_cfg(), deg)(state, torch_batch(scene, V), scene["protos"],
                                                  scene["bg"], 1.0, device="cpu")
    got = state.to_numpy()

    for k in ("loss", "l1", "psnr"):
        assert float(getattr(tm, k)) == pytest.approx(float(getattr(jm, k)), rel=1e-5), k
    for k in ("overflow", "clipped", "num_alive"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    assert float(grads.loss) == float(tm.loss)
    for k in TRAINABLE:
        g_jax = (after["mu"][k] - np.float32(0.9) * before["mu"][k]) / np.float32(0.1)
        g_port = grads.params[k].numpy()
        if deg == 0 and k == "features_rest":
            assert not np.any(g_port) and not np.any(after["mu"][k] - before["mu"][k] * 0.9)
            continue
        assert rel_err(g_port, g_jax) <= 1e-4, (k, rel_err(g_port, g_jax))
        np.testing.assert_allclose(got["gaussians"][k], after["gaussians"][k], rtol=0,
                                   atol=1e-5, err_msg=k)
        assert rel_err(got["mu"][k], after["mu"][k]) <= 1e-4, k
        assert rel_err(got["nu"][k], after["nu"][k]) <= 1e-4, k
    for k in STAT_FIELDS:
        assert rel_err(got["stats"][k], after["stats"][k]) <= 1e-4, k
    for k in ("step", "adam_step", "max_overflow", "max_clipped"):
        assert got[k] == after[k], k


def synthetic_batch(rng, capacity=64, n=48, width=48, height=32):
    """tests/test_train_step.py:synthetic_batch through the port: a ground
    truth cloud rendered from 3 cameras, and a perturbed trainee."""
    cams = [TCamera.create(R=np.eye(3), T=np.array([dx, 0.0, 0.0]), fovx=0.9, fovy=0.7,
                           width=width, height=height, device="cpu") for dx in (-0.2, 0.0, 0.2)]
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.4 + np.array([0, 0, 3.0], np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    gt_g = create_from_points(pts, cols, n, init_scale=np.full(n, 0.01), initial_opacity=0.9,
                              device="cpu")
    cfg = tconfig.TrainConfig(raster=tconfig.RasterizeConfig(
        tile=16, max_per_tile=128, max_tiles_per_gaussian=16, chunk=32))
    outs = [render(c, gt_g, cfg.raster, torch.zeros(3), 0, device="cpu") for c in cams]
    batch = ViewBatch(cameras=cams,
                      image=torch.stack([o.color.permute(2, 0, 1) for o in outs]),
                      depth_mono=torch.stack([o.depth for o in outs]),
                      feature=torch.zeros((3, 3, height, width)),
                      seg_map=torch.zeros((3, height, width), dtype=torch.int32))
    init_pts = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    g = create_from_points(init_pts, np.full((n, 3), 0.5, np.float32), capacity,
                           init_scale=np.full(n, 0.01), device="cpu")
    return g, batch, cfg


def test_loss_decreases(rng):
    """tests/test_train_step.py:test_loss_decreases through the port."""
    g, batch, cfg = synthetic_batch(rng)
    state = TrainState.create(g, device="cpu")
    step = make_train_step(cfg, sh_degree=0)
    first = None
    for _ in range(30):
        state, m = step(state, batch, torch.ones((4, 3)), torch.zeros(3), 1.0, device="cpu")
        if first is None:
            first = (float(m.l1), float(m.psnr))
    assert np.isfinite(float(m.loss))
    assert float(m.l1) < first[0] * 0.8, (first, float(m.l1))
    assert float(m.psnr) > first[1] + 1.0, (first, float(m.psnr))
    assert state.step == 30 and state.opt_state.step == 30
    assert float(state.stats.denom.max()) > 0


def _mesh(data=1, gauss=1, tile=1):
    from sdpgs_torch.parallel.mesh import Mesh

    shape = dict(data=data, gauss=gauss, tile=tile)
    return Mesh(shape=shape, coords=dict.fromkeys(shape, 0), groups=dict.fromkeys(shape))


def _sharding(mesh):
    from sdpgs_torch.parallel.sharding import StateSharding

    return StateSharding(mesh=mesh, capacity=64, slots=(0, 64))


@pytest.mark.parametrize("kw", [dict(with_pseudo=True, tile_mesh=_mesh(data=2, tile=2)),
                                dict(tile_mesh=_mesh(gauss=2)),
                                dict(out_shardings=_sharding(_mesh()), tile_mesh=_mesh(tile=2))])
def test_later_slices_refused(kw):
    """A mesh step that could run unsharded by mistake is refused: a mesh
    with data or gauss axes needs the state's sharding, which must name the
    same mesh."""
    with pytest.raises(ValueError, match="out_shardings|different meshes"):
        make_train_step(torch_cfg(), 3, **kw)
