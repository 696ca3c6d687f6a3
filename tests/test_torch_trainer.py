"""The port's Trainer (train/loop.py) and SyntheticScene against
sdpgs_tpu's, on the CPU, and the Trainer's own policies.

Both Trainers train one in-memory scene whose images JAX rendered (48x32,
40 points, capacity 128) for 30 iterations: densify at 10 and 20 with a
percent_dense so large that every hit clones (no random draw enters),
proximity bridging at 10 only (a cameras_extent small enough that it
spawns), a pseudo window at 23-26 with a smooth closed-form stand-in for
the depth net, and the opacity reset at 23. Required: the same view and
pseudo-camera order, the same event iterations, the same alive count after
every event, and the logged loss and PSNR within LOSS_RTOL (float32
formulas summed in other orders, carried through 30 steps and two
events). Port-side tests: the capacity ladder (K, D, slab; JAX's rank
kernel rungs never fire), the reaction to the running maxima, the
persisted report, and a resume from a checkpoint that equals an unbroken
run."""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu import config as jconfig
from sdpgs_tpu.data import synthetic as jsynthetic
from sdpgs_tpu.train import loop as jloop
from sdpgs_torch import config as tconfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import BUFFER_FIELDS, PARAM_FIELDS, Gaussians
from sdpgs_torch.data import synthetic as tsynthetic
from sdpgs_torch.data.camera_utils import LoadedCamera
from sdpgs_torch.ops.rasterize import binning
from sdpgs_torch.train import loop as tloop
from test_torch_adam import _assert_same_arrays
from test_torch_pseudo_step import smooth_mono
from torch_threads import few_threads  # noqa: F401  (autouse)

RASTER = dict(tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32)
ITERATIONS, LOG_EVERY = 30, 5
EXTENT = 0.05            # proximity spawns where mean 3-NN sq dist > 5 x this
LOSS_RTOL = 1e-4         # logged loss and PSNR, port against JAX
OPTIM = dict(densify_from_iter=5, densification_interval=10, densify_until_iter=25,
             proximity_until_iter=15, start_sample_pseudo=22, end_sample_pseudo=27,
             percent_dense=1000.0, test_iterations=(), save_iterations=(),
             checkpoint_iterations=())


def jax_cfg():
    cfg = jconfig.TrainConfig()
    cfg.raster = jconfig.RasterizeConfig(**RASTER, use_pallas=False, use_rank_kernel=False)
    for k, v in OPTIM.items():
        setattr(cfg.optim, k, v)
    return cfg


def torch_cfg(**optim):
    cfg = tconfig.TrainConfig(raster=tconfig.RasterizeConfig(**RASTER))
    for k, v in {**OPTIM, **optim}.items():
        setattr(cfg.optim, k, v)
    return cfg


class PortScene:
    """The JAX scene's cameras, images, maps and cloud, carried across."""

    pseudo_camera = tsynthetic.SyntheticScene.pseudo_camera

    def __init__(self, js):
        self.model_path = ""
        self.train_cameras = [self._camera(c) for c in js.train_cameras]
        self.test_cameras = [self._camera(c) for c in js.test_cameras]
        self.prototypes = js.prototypes
        self.cameras_extent = js.cameras_extent
        self.gaussians = Gaussians.from_numpy(
            {k: np.asarray(getattr(js.gaussians, k)) for k in PARAM_FIELDS + BUFFER_FIELDS},
            device="cpu")
        self.pseudo_poses = js.pseudo_poses
        self.pseudo_fovx, self.pseudo_fovy = js.pseudo_fovx, js.pseudo_fovy
        self.pseudo_width, self.pseudo_height = js.pseudo_width, js.pseudo_height

    @staticmethod
    def _camera(c):
        cam = Camera.create(R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy, width=c.width,
                            height=c.height, device="cpu")
        return LoadedCamera(camera=cam, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
                            image=c.image, depth_mono=c.depth_mono,
                            point_feature=c.point_feature, seg_map=c.seg_map,
                            feature_dict=c.feature_dict, bounds=c.bounds,
                            image_name=c.image_name)

    def save(self, iteration, gaussians):
        pass


def jax_scene():
    js = jsynthetic.SyntheticScene(seed=0, n_points=40, capacity=128, n_pseudo=4, n_segments=2)
    js.cameras_extent = EXTENT
    return js


def record(trainer, is_port):
    """Wrap the Trainer's view pop, pseudo pop, densify and opacity reset
    to log what each did and when."""
    log = SimpleNamespace(views=[], pseudos=[], densify=[], reset=[])
    nv, np_, md, mr = (trainer._next_view, trainer._next_pseudo, trainer._maybe_densify,
                       trainer._maybe_reset_opacity)

    def next_view():
        log.views.append(nv())
        return log.views[-1]

    def next_pseudo():
        log.pseudos.append(np_())
        return log.pseudos[-1]

    def maybe_densify(it):
        info = md(it)
        if info is not None:
            log.densify.append((it, int(info.num_alive), int(info.spawned)))
        return info

    def max_opacity():
        g = trainer.state.gaussians
        op = torch.sigmoid(g.opacity.detach()) if is_port else \
            torch.from_numpy(np.array(1 / (1 + jnp.exp(-g.opacity))))
        alive = (g.alive > 0) if is_port else torch.from_numpy(np.asarray(g.alive) > 0)
        return float(op[alive].max())

    def maybe_reset(it):
        before = max_opacity()
        mr(it)
        if max_opacity() <= 0.0100001 < before:
            log.reset.append(it)

    trainer._next_view, trainer._next_pseudo = next_view, next_pseudo
    trainer._maybe_densify, trainer._maybe_reset_opacity = maybe_densify, maybe_reset
    return log


@pytest.fixture(scope="module")
def runs():
    js = jax_scene()
    scene = PortScene(js)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDPGS_COMPILE_CACHE", "off")
        jt = jloop.Trainer(jax_cfg(), scene=js,
                           mono_depth_fn=lambda img: smooth_mono(img, jnp))
        jlog = record(jt, is_port=False)
        jhist = jt.train(iterations=ITERATIONS, log_every=LOG_EVERY)
    tt = tloop.Trainer(torch_cfg(), scene=scene, mono_depth_fn=lambda img: smooth_mono(img, torch),
                       device="cpu")
    tlog = record(tt, is_port=True)
    thist = tt.train(iterations=ITERATIONS, log_every=LOG_EVERY)
    return dict(jax=(jt, jlog, jhist), port=(tt, tlog, thist), scene=scene)


def test_same_order_and_events(runs):
    (_, jlog, _), (_, tlog, _) = runs["jax"], runs["port"]
    assert tlog.views == jlog.views and len(tlog.views) == ITERATIONS
    assert tlog.pseudos == jlog.pseudos and len(tlog.pseudos) == tloop.REPROJ_PREFETCH
    assert [d[0] for d in tlog.densify] == [d[0] for d in jlog.densify] == [10, 20]
    assert tlog.densify == jlog.densify, (tlog.densify, jlog.densify)
    assert all(d[2] > 0 for d in tlog.densify)
    assert tlog.reset == jlog.reset == [23]


def test_history_matches(runs):
    (jt, _, jhist), (tt, _, thist) = runs["jax"], runs["port"]
    assert [h["iter"] for h in thist] == [h["iter"] for h in jhist]
    assert [h["alive"] for h in thist] == [h["alive"] for h in jhist]
    for th, jh in zip(thist, jhist):
        for k in ("loss", "psnr"):
            assert th[k] == pytest.approx(jh[k], rel=LOSS_RTOL), (th["iter"], k, th[k], jh[k])
    assert tt.cfg.raster.max_per_tile == jt.cfg.raster.max_per_tile
    assert tt.cfg.raster.max_tiles_per_gaussian == jt.cfg.raster.max_tiles_per_gaussian
    ev_t, ev_j = tt.evaluate(sh_degree=0), jt.evaluate(sh_degree=0)
    for k in ("l1", "psnr", "ssim"):
        assert ev_t[k] == pytest.approx(ev_j[k], rel=LOSS_RTOL), k
    assert ev_t["n_views"] == ev_j["n_views"] == 1


def test_synthetic_scene_matches_jax():
    kw = dict(seed=1, n_points=48, capacity=64, n_pseudo=5, n_segments=3, n_test=2)
    js = jsynthetic.SyntheticScene(**kw)
    ts = tsynthetic.SyntheticScene(**kw, device="cpu")
    np.testing.assert_array_equal(ts.prototypes, js.prototypes)
    np.testing.assert_array_equal(ts.pseudo_poses, js.pseudo_poses)
    assert ts.cameras_extent == js.cameras_extent
    got = ts.gaussians.to_numpy()
    for k in PARAM_FIELDS + BUFFER_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js.gaussians, k)), err_msg=k)
    for tc, jc in zip(ts.train_cameras + ts.test_cameras, js.train_cameras + js.test_cameras):
        np.testing.assert_array_equal(tc.camera.view.numpy(), np.asarray(jc.camera.view))
        np.testing.assert_allclose(tc.image, jc.image, atol=1e-5)
        np.testing.assert_allclose(tc.point_feature, jc.point_feature, atol=1e-5)
        assert (tc.seg_map == jc.seg_map).mean() > 0.999
        assert tc.image_name == jc.image_name
    cam, R, T = ts.pseudo_camera(3)
    jcam, jR, jT = js.pseudo_camera(3)
    np.testing.assert_array_equal(cam.full_proj.numpy(), np.asarray(jcam.full_proj))


def policy_trainer(width=1297, height=840, capacity=1 << 22):
    """The policy alone: no scene, only the size the ceiling is derived
    from (by default mip-NeRF 360 at 1/4 resolution, 1,107 32-pixel tiles,
    on the CPU's fixed budget)."""
    t = tloop.Trainer.__new__(tloop.Trainer)
    t.cfg = tconfig.TrainConfig()
    t._steps = {"dummy": object()}
    t.device = torch.device("cpu")
    t.scene = SimpleNamespace(train_cameras=[SimpleNamespace(width=width, height=height)])
    t.state = SimpleNamespace(gaussians=SimpleNamespace(capacity=capacity))
    return t


def test_capacity_ladder_policy():
    t = policy_trainer()
    ceiling = t.max_per_tile_ceiling()
    assert ceiling == binning.max_per_tile_ceiling(41 * 27, 32, 1 << 22, binning.CPU_BUDGET)
    assert ceiling > 8192                     # past the JAX package's fixed cap
    r0 = t.cfg.raster
    t._maybe_grow_max_per_tile(73)
    assert t.cfg.raster.max_per_tile == 2 * r0.max_per_tile and not t._steps
    # JAX's rank-kernel rungs (S, pooled tail, grouped) never fire in the port
    for k in ("rank_block_slots", "rank_block_tail", "rank_block_grouped"):
        assert getattr(t.cfg.raster, k) == getattr(r0, k), k
    while t.cfg.raster.max_per_tile < ceiling:
        t._maybe_grow_max_per_tile(1)
    assert t.cfg.raster.max_per_tile == ceiling
    t._steps = {"dummy": object()}
    t._maybe_grow_max_per_tile(5)             # at the ceiling: no new step
    assert t._steps and t.cfg.raster.max_per_tile == ceiling

    d_ceiling = t.max_tiles_per_gaussian_ceiling()
    assert d_ceiling == binning.max_tiles_per_gaussian_ceiling(1 << 22, binning.CPU_BUDGET)
    assert d_ceiling > 32                     # past the JAX package's fixed cap
    t._maybe_grow_tiles_per_gaussian(12)
    assert t.cfg.raster.max_tiles_per_gaussian == 16 and not t._steps
    t._maybe_grow_tiles_per_gaussian(12)
    assert t.cfg.raster.max_tiles_per_gaussian == 32
    while t.cfg.raster.max_tiles_per_gaussian < d_ceiling:
        t._maybe_grow_tiles_per_gaussian(12)
    assert t.cfg.raster.max_tiles_per_gaussian == d_ceiling
    t._steps = {"dummy": object()}
    t._maybe_grow_tiles_per_gaussian(3)
    assert t._steps and t.cfg.raster.max_tiles_per_gaussian == d_ceiling
    # the port's backward has no gradient window: no rung moves its slack
    assert t.cfg.raster.grad_window_slack == r0.grad_window_slack


def small_scene(**kw):
    return tsynthetic.SyntheticScene(seed=0, n_points=64, capacity=128, device="cpu", **kw)


def no_events(**optim):
    return torch_cfg(densify_from_iter=10_000, densify_until_iter=0,
                     start_sample_pseudo=10_000, **optim)


def test_ladder_reacts_to_the_running_max():
    """A drop between log points (injected into the running max) makes the
    next log point double D and reset the maxima."""
    tt = tloop.Trainer(no_events(), scene=small_scene(), device="cpu")
    tt.state.max_clipped = torch.tensor(9, dtype=torch.int32)
    d0 = tt.cfg.raster.max_tiles_per_gaussian
    tt.train(iterations=5, log_every=5)
    assert tt.cfg.raster.max_tiles_per_gaussian == 2 * d0
    assert int(tt.state.max_clipped) == 0 and int(tt.state.max_overflow) == 0


def test_training_report_persisted(tmp_path):
    scene = small_scene()
    scene.model_path = str(tmp_path / "model")
    tt = tloop.Trainer(no_events(test_iterations=(4,)), scene=scene, device="cpu")
    tt.train(iterations=6, log_every=3)
    res = json.loads((tmp_path / "model" / "eval_results.json").read_text())
    assert len(res) == 1 and res[0]["iteration"] == 4
    for split in ("test", "train"):
        assert {"l1", "psnr", "ssim"} <= set(res[0][split])
        assert np.isfinite(res[0][split]["psnr"])
    assert res[0]["total_points"] == 64
    hist = json.loads((tmp_path / "model" / "training_history.json").read_text())
    assert [h["iter"] for h in hist] == [3, 6]


def test_resume_from_checkpoint_equals_an_unbroken_run(tmp_path):
    """One train view (so the host's view pop needs no state), a split
    densify at 10 after the checkpoint at 6 (its noise comes from the
    restored generator): the resumed run ends bit-identical."""
    optim = dict(densify_from_iter=5, densify_until_iter=15, percent_dense=0.01,
                 densify_grad_threshold=2e-4, start_sample_pseudo=10_000,
                 checkpoint_iterations=(6,))
    scene = small_scene(n_train=1)
    scene.model_path = str(tmp_path / "a")
    unbroken = tloop.Trainer(torch_cfg(**optim), scene=scene, device="cpu")
    unbroken.train(iterations=12, log_every=6)
    scene.model_path = str(tmp_path / "b")
    resumed = tloop.Trainer(torch_cfg(**optim), scene=scene, device="cpu")
    resumed.restore(tmp_path / "a" / "checkpoints", 6)
    assert resumed.state.step == 6
    resumed.train(iterations=12, log_every=6)
    want = unbroken.state.to_numpy()
    # the densify split some Gaussians: their slots died, children were born
    assert (want["gaussians"]["alive"] != scene.gaussians.alive.numpy()).sum() > 2
    _assert_same_arrays(resumed.state.to_numpy(), want)


def test_depth_net_from_cfg_weights(tmp_path):
    """Without a mono_depth_fn the Trainer loads cfg.model.dpt_weights (a
    converted .npz) as a MonoDepth, in bf16 as dpt_bf16 asks; a missing
    file leaves the pseudo steps without a depth net."""
    from sdpgs_torch.models import dpt
    from sdpgs_torch.models.depth_estimator import MonoDepth

    arch = dpt.DPTArch.tiny_hybrid()
    path = tmp_path / "dpt.npz"
    dpt.save_params(path, dpt.random_params(arch, seed=0), arch)
    cfg = no_events()
    cfg.model.dpt_weights = str(path)
    tt = tloop.Trainer(cfg, scene=small_scene(), device="cpu")
    assert isinstance(tt.mono_depth_fn, MonoDepth) and tt.mono_depth_fn.dtype == torch.bfloat16
    cfg.model.dpt_weights = str(tmp_path / "missing.npz")
    assert tloop.Trainer(cfg, scene=small_scene(), device="cpu").mono_depth_fn is None


def test_trainer_refuses_what_later_slices_bring():
    # a mesh needs a torch.distributed group of as many ranks
    with pytest.raises(ValueError, match="needs 2 torch.distributed ranks, have 1"):
        tloop.Trainer(tconfig.TrainConfig(mesh_data=2), scene=object(), device="cpu")
    # without a scene the Trainer loads one from cfg.model.source_path
    with pytest.raises(ValueError, match="could not recognize scene type"):
        tloop.Trainer(tconfig.TrainConfig(), device="cpu")


def test_make_lpips_fn(tmp_path):
    """No weights: None for every pair. Weights: the LPIPS network on the
    device asked for (it used to raise until the network was ported)."""
    from sdpgs_torch.eval.metrics import make_lpips_fn
    from test_lpips import random_lpips_params

    zeros = torch.zeros(3, 4, 4)
    assert make_lpips_fn(None, device="cpu")(zeros, zeros) is None
    assert make_lpips_fn("/nonexistent/lpips.npz", device="cpu")(None, None) is None
    np.savez(tmp_path / "lpips.npz", **random_lpips_params(np.random.default_rng(0)))
    fn = make_lpips_fn(str(tmp_path / "lpips.npz"), device="cpu")
    a, b = torch.rand(3, 16, 16), torch.rand(3, 16, 16)
    assert fn(a, a) == 0.0 and fn(a, b) > 0.0
