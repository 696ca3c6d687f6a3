"""The port's multi-card training (``sdpgs_torch/parallel/``) on gloo ranks
on the CPU, against sdpgs_tpu.

One pool of 4 spawned ranks (``torch_ranks.RankPool``, one thread each)
serves every case; the JAX side runs on conftest's 8 virtual CPU devices.

- the tile-sharded render on a (data=1, gauss=1, tile=4) mesh: bit for bit
  the port's whole render, and against JAX's ``render_tile_sharded`` on
  ``make_mesh(data=2, gauss=1, tile=4)`` within the tolerances the port's
  whole render is held to against JAX's (test_torch_render.py: 2e-5 for
  colour and alpha, 2e-4 for depth and feature; here one pixel of 3,072
  differs from JAX by 1.2e-6 in both the whole and the sharded render),
  radii and overflow equal;
- its gradients against JAX's single-device ``render`` gradients, at rtol
  1e-4, atol 1e-5 (the tile sum reorders the payload accumulation), and
  equal on every tile rank;
- one sharded train step at (2, 1, 2) and (1, 2, 2) against JAX's
  single-device ``make_train_step`` from the same state after 3 steps
  (non-zero moments) at V = 2: loss rtol 1e-5, PSNR 1e-4, xyz and opacity
  rtol 1e-4 / atol 1e-6 (JAX test_parallel.py's tolerances), the gathered
  moments and statistics within 1e-4 of each field's largest (the same
  formulas summed in another order), telemetry and alive count exact, and
  every rank's gathered state identical;
- one sharded pseudo step at (2, 1, 2) against the port's single-card one
  (a smooth stand-in depth net; the train view's labels from the other
  data rank) at the same tolerances;
- the sharding rules (slot ranges, round trips, the ZeRO update bit for
  bit, the batch split) and ``make_mesh``'s shapes;
- a 2-rank ``certify_sharded_training`` in its own pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdpgs_tpu.core.camera import Camera as JCamera
from sdpgs_tpu.parallel import make_mesh as j_make_mesh
from sdpgs_tpu.parallel import render_tile_sharded as j_render_tile_sharded
from sdpgs_tpu.render import render as j_render
from sdpgs_tpu.train.state import TrainState as JState
from sdpgs_tpu.train.step import make_train_step as j_make_train_step
from sdpgs_torch.opt.adam import TRAINABLE
from sdpgs_torch.train.state import STAT_FIELDS
from test_torch_adam import jax_state_arrays
from test_torch_core import jax_gaussians, random_arrays
from test_torch_train_step import CAM, H, RASTER, S, TRANSLATIONS, W, jax_batch, jax_cfg, rel_err
from torch_ranks import RankPool

RENDER_RASTER = dict(tile=16, max_per_tile=64, max_tiles_per_gaussian=8, chunk=32)
RENDER_CAM = dict(R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.7, width=64, height=48)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def step_data():
    """Inputs, and the JAX state after 3 steps at V = 2 (numpy)."""
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
        translations=TRANSLATIONS, cam=CAM,
    )
    step = j_make_train_step(jax_cfg(), 1)
    args = (jax_batch(data, V), jnp.asarray(data["protos"]), jnp.asarray(data["bg"]),
            jnp.float32(1.0))
    js = JState.create(jax_gaussians(data["arrays"]))
    for _ in range(3):
        js, _ = step(js, *args)
    data["before"] = jax_state_arrays(jax.tree_util.tree_map(lambda a: np.array(a), js))
    js, jm = step(js, *args)
    data["after"] = jax_state_arrays(js)
    data["jax_metrics"] = jm
    return data


def rank_args(data):
    keys = ("image", "mono", "feature", "seg", "protos", "bg", "translations", "cam")
    return {k: data[k] for k in keys}


def test_make_mesh_shapes(pool):
    res = pool.run("mesh_shapes", [(-1, 2, 1), (2, 1, 2), (1, 1, 4)])
    for rank, (per_rank, refused) in enumerate(res):
        assert refused == [(3, 1, 1), (-1, 3, 1)]    # products that are not 4 ranks
        (s0, c0, g0), (s1, c1, g1), (s2, c2, g2) = per_rank
        assert s0 == dict(data=2, gauss=2, tile=1)
        assert c0 == dict(data=rank // 2, gauss=rank % 2, tile=0)
        assert g0 == dict(data=2, gauss=2, tile=None)
        assert s1 == dict(data=2, gauss=1, tile=2)
        assert c1 == dict(data=rank // 2, gauss=0, tile=rank % 2)   # tile innermost
        assert g1 == dict(data=2, gauss=None, tile=2)
        assert s2 == dict(data=1, gauss=1, tile=4) and c2["tile"] == rank
        assert g2 == dict(data=None, gauss=None, tile=4)


@pytest.fixture(scope="module")
def render_case(pool):
    """The same cloud rendered by JAX (tile-sharded on 8 devices, and its
    single-device gradients) and by the port on 4 tile ranks."""
    from sdpgs_tpu.config import RasterizeConfig

    rng = np.random.default_rng(1)
    arrays = random_arrays(rng, P=256, n=96)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    target = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    cfg = RasterizeConfig(**RENDER_RASTER, use_pallas=False, use_rank_kernel=False)
    cam = JCamera.create(**RENDER_CAM)
    g = jax_gaussians(arrays)
    mesh = j_make_mesh(data=2, gauss=1, tile=4)
    ref = jax.jit(lambda g: j_render_tile_sharded(cam, g, cfg, jnp.asarray(bg), 1, mesh))(g)

    def loss(params):
        out = j_render(cam, g.replace(**params), cfg, jnp.asarray(bg), 1)
        return jnp.sum((out.color - target) ** 2) + jnp.sum(out.depth) * 1e-3

    grads = jax.jit(jax.grad(loss))({k: getattr(g, k) for k in TRAINABLE})
    ranks = pool.run("tile_render", arrays, RENDER_CAM, RENDER_RASTER, bg, target, (1, 1, 4))
    return ref, grads, ranks


RENDER_TOL = dict(color=2e-5, alpha=2e-5, depth=2e-4, feature=2e-4)


def test_tile_sharded_render_matches_jax(render_case):
    ref, _, ranks = render_case
    for both in ranks:
        res, whole = both["sharded"], both["whole"]
        for k, tol in RENDER_TOL.items():
            np.testing.assert_array_equal(res[k], whole[k], err_msg=k)
            np.testing.assert_allclose(res[k], np.asarray(getattr(ref, k)), rtol=0, atol=tol,
                                       err_msg=k)
        np.testing.assert_array_equal(res["radii"], np.asarray(ref.radii))
        assert res["overflow"] == int(ref.overflow) == whole["overflow"]
        assert res["clipped"] == int(ref.clipped)
    assert float(np.asarray(ref.alpha).mean()) > 0.05


def test_tile_sharded_gradients_match_jax(render_case):
    _, grads, ranks = render_case
    ranks = [both["sharded"] for both in ranks]
    for res in ranks:
        for k in TRAINABLE:
            np.testing.assert_allclose(res["grads"][k], np.asarray(grads[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    for k in TRAINABLE:    # the tile ranks agree bit for bit after the sum
        assert all(np.array_equal(r["grads"][k], ranks[0]["grads"][k]) for r in ranks)


def assert_step_matches(got, ref_metrics, after):
    m = got["metrics"]
    assert m["loss"] == pytest.approx(float(ref_metrics.loss), rel=1e-5)
    assert m["psnr"] == pytest.approx(float(ref_metrics.psnr), rel=1e-4)
    assert m["l1"] == pytest.approx(float(ref_metrics.l1), rel=1e-5)
    for k in ("overflow", "clipped", "num_alive", "slab"):
        assert m[k] == int(getattr(ref_metrics, k)), k
    s = got["state"]
    for k in ("xyz", "opacity"):
        np.testing.assert_allclose(s["gaussians"][k], after["gaussians"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in TRAINABLE:
        np.testing.assert_allclose(s["gaussians"][k], after["gaussians"][k], rtol=0, atol=1e-5,
                                   err_msg=k)
        assert rel_err(s["mu"][k], after["mu"][k]) <= 1e-4, k
        assert rel_err(s["nu"][k], after["nu"][k]) <= 1e-4, k
    for k in STAT_FIELDS:
        assert rel_err(s["stats"][k], after["stats"][k]) <= 1e-4, k
    for k in ("step", "adam_step", "max_overflow", "max_clipped", "max_slab"):
        assert s[k] == after[k], k


def same_state(a, b) -> bool:
    return all(np.array_equal(a[part][k], b[part][k])
               for part in ("gaussians", "mu", "nu", "stats") for k in a[part])


@pytest.mark.parametrize("axes", [(2, 1, 2), (1, 2, 2)], ids=["data2_tile2", "gauss2_tile2"])
def test_sharded_step_matches_jax(pool, step_data, axes):
    ranks = pool.run("sharded_step", step_data["before"], rank_args(step_data), RASTER, axes, 1)
    for got in ranks:
        assert_step_matches(got, step_data["jax_metrics"], step_data["after"])
        assert same_state(got["state"], ranks[0]["state"])   # parameters replicated
    slots = sorted({tuple(r["slots"]) for r in ranks})
    assert slots == ([(0, 256)] if axes[1] == 1 else [(0, 128), (128, 256)])


def test_sharded_pseudo_step_matches_single(pool, step_data):
    K = np.array([[W / (2 * np.tan(0.45)), 0, W / 2], [0, H / (2 * np.tan(0.35)), H / 2],
                  [0, 0, 1]], np.float32)
    pseudo = dict(T=np.array([0.05, 0.02, 0.0]), K=K, train_view_idx=1,
                  optim=dict(pseudo_seg_from_train_view=True))
    before = dict(step_data["before"], step=4500)
    args = (before, rank_args(step_data), RASTER)
    single = pool.run("single_step", *args, 1, pseudo)
    ranks = pool.run("sharded_step", *args, (2, 1, 2), 1, pseudo)
    ref = single[0]
    for got in ranks:
        m, r = got["metrics"], ref["metrics"]
        assert m["loss"] == pytest.approx(r["loss"], rel=1e-5)
        assert m["psnr"] == pytest.approx(r["psnr"], rel=1e-4)
        for k in ("overflow", "clipped", "num_alive", "slab"):
            assert m[k] == r[k], k
        for k in TRAINABLE:
            np.testing.assert_allclose(got["state"]["gaussians"][k], ref["state"]["gaussians"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            assert rel_err(got["state"]["mu"][k], ref["state"]["mu"][k]) <= 1e-4, k
        assert same_state(got["state"], ranks[0]["state"])
    assert ref["metrics"]["loss"] != pytest.approx(
        pool.run("single_step", before, rank_args(step_data), RASTER, 1)[0]["metrics"]["loss"],
        rel=1e-3)   # the pseudo terms count


@pytest.mark.parametrize("axes", [(2, 2, 1), (1, 4, 1)], ids=["data2_gauss2", "gauss4"])
def test_sharding_rules(pool, step_data, axes):
    ranks = pool.run("sharding_rules", step_data["before"], rank_args(step_data), axes)
    per = 256 // axes[1]
    for rank, r in enumerate(ranks):
        g, d = rank % axes[1], rank // axes[1]
        assert tuple(r["slots"]) == (g * per, (g + 1) * per)
        assert r["round_trip"] and r["refused"] and r["odd_refused"]
        assert r["params_equal"] and r["moments_equal"]
        per_v = 2 // axes[0]
        assert tuple(r["views"]) == (d * per_v, (d + 1) * per_v) and r["images_equal"]


def test_certify_two_ranks(tmp_path):
    pool = RankPool(2, tmp_path)
    try:
        ranks = pool.run("certify", 2, str(tmp_path / "work"))
    finally:
        pool.close()
    for summary in ranks:
        assert summary["mesh"] == (2, 1, 1)
        assert summary["densify_iters"] == [20, 40, 60]
        assert summary["reset_iters"] == [35, 55]
        assert summary["ladder_events"], "the ladder must fire (D=2 scene clips)"
        assert summary["resume_bitexact"] and summary["restore_exact"]
        lo, hi = summary["final_alive_single"]
        assert lo == hi    # the plain path is deterministic: every rank's single leg agrees
    assert ranks[0] == ranks[1]
