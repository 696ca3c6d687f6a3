"""The port's pseudo-view train step against sdpgs_tpu's, on the CPU (the
plain versions of K1-K6).

One step from the same state: a JAX TrainState that has taken 3 plain
steps (non-zero Adam moments) is moved to iteration 4500 (the segment
term live) or 3000 (off) and carried across; both packages take one
pseudo step with 3 train depths that fuse (a slanted plane seen by every
camera, so views agree). Cases: labels from the pseudo view or from the
train view, no depth net (the reprojection term alone), the reprojection
warped inside the step, and the tiny_hybrid DPT at 384x512 as the depth
net. The other depth-net cases use a smooth closed-form map written the
same way in both packages, so the step's own wiring is held to the plain
step's tolerances (tests/test_torch_train_step.py): gradients within
1e-4 of each field's largest, parameters 1e-5 absolute, moments and
statistics 1e-4 of the field's largest, loss, L1 and PSNR 1e-5 relative,
telemetry exact.

The DPT case: the input gradient of 1 - pearson(depth, -dpt(image))
through a random-weight DPT is ill-conditioned in float32 (its 0.3%-wide
depth map sits on a ReLU; JAX's and the port's float32 gradients each
differ from a float64 run of the port by 8% of the largest, and from
each other by 0.4%), so there gradients and first moments are held to
1e-2 of the field's largest (measured 5.2e-3), second moments to 1e-2
(2.2e-3) and parameters to 5e-4 absolute (1.4e-4); statistics, metrics
and telemetry as above. Each pseudo term is checked non-zero on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu import config as jconfig
from sdpgs_tpu.core.camera import Camera as JCamera
from sdpgs_tpu.losses import reproject_fused_depth as j_reproject
from sdpgs_tpu.models import depth_estimator as jde
from sdpgs_tpu.models import dpt as jdpt
from sdpgs_tpu.train.state import TrainState as JState
from sdpgs_tpu.train.step import PseudoInputs as JPseudo
from sdpgs_tpu.train.step import ViewBatch as JBatch
from sdpgs_tpu.train.step import make_train_step as j_make_train_step
from sdpgs_torch import config as tconfig
from sdpgs_torch.core.camera import Camera as TCamera
from sdpgs_torch.losses import reproject_fused_depth
from sdpgs_torch.models import depth_estimator as tde
from sdpgs_torch.models import dpt as tdpt
from sdpgs_torch.opt.adam import TRAINABLE
from sdpgs_torch.train import step as tstep
from sdpgs_torch.train.state import STAT_FIELDS, TrainState
from sdpgs_torch.train.step import PseudoInputs, ViewBatch, loss_and_grads, make_train_step
from test_torch_adam import jax_state_arrays
from test_torch_core import jax_gaussians, random_arrays
from torch_threads import few_threads  # noqa: F401  (autouse)

RASTER = dict(tile=16, max_per_tile=128, max_tiles_per_gaussian=8, chunk=32)
W, H, S = 72, 56, 4
CAM = dict(R=np.eye(3), fovx=0.9, fovy=0.7, width=W, height=H)
TRAIN_T = [np.array([0.1 * i - 0.1, 0.0, 0.0]) for i in range(3)]
PSEUDO_T = np.array([0.03, 0.01, 0.0])
CASES = {
    "step4500": dict(step=4500),
    "step3000": dict(step=3000),
    "seg_from_train_view": dict(step=4500, seg_from_train=True),
    "no_depth_net": dict(step=4500, mono=None),
    "reproj_in_step": dict(step=4500, mono=None, fused=False),
    "tiny_hybrid_dpt": dict(step=4500, mono="dpt"),
}
# (gradient and first moment, second moment, parameter) tolerances
TOLS = {"smooth": (1e-4, 1e-4, 1e-5), None: (1e-4, 1e-4, 1e-5), "dpt": (1e-2, 1e-2, 5e-4)}


def smooth_mono(img, xp):
    """A closed-form, smooth stand-in for the depth net: [3, H, W] -> [H, W]."""
    return 2.0 + xp.mean(img, 0) + 0.5 * img[0] * img[1] - 0.3 * img[2] ** 2


def plane_depth(T: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Depth of the world plane Z = 3 + 0.3 X seen from a camera with R = I
    and translation T (centre -T): every camera sees the same surface."""
    cx = -T[0]
    xs = (np.arange(W) - K[0, 2]) / K[0, 0]
    s = (3.0 + 0.3 * cx) / (1.0 - 0.3 * xs)
    return np.broadcast_to(s[None, :], (H, W)).astype(np.float32)


def jax_cfg(seg_from_train=False):
    cfg = jconfig.TrainConfig()
    cfg.raster = jconfig.RasterizeConfig(**RASTER, use_pallas=False, use_rank_kernel=False)
    cfg.optim.pseudo_seg_from_train_view = seg_from_train
    return cfg


def torch_cfg(seg_from_train=False):
    cfg = tconfig.TrainConfig(raster=tconfig.RasterizeConfig(**RASTER))
    cfg.optim.pseudo_seg_from_train_view = seg_from_train
    return cfg


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    cams = [JCamera.create(T=t, **CAM) for t in TRAIN_T]
    K = np.asarray(cams[0].intrinsics_matrix())
    data = dict(
        arrays=random_arrays(rng, P=256, n=220),
        image=rng.uniform(size=(1, 3, H, W)).astype(np.float32),
        mono=rng.uniform(1, 8, size=(1, H, W)).astype(np.float32),
        feature=rng.normal(size=(1, 3, H, W)).astype(np.float32),
        seg=rng.integers(0, S, size=(1, H, W)).astype(np.int32),
        protos=rng.normal(size=(S, 3)).astype(np.float32),
        bg=np.array([0.1, 0.2, 0.3], np.float32),
        K=K,
        train_depths=np.stack([plane_depth(t, K) for t in TRAIN_T]),
        R_train=np.stack([np.asarray(c.view[:3, :3]) for c in cams]),
        t_train=np.stack([np.asarray(c.view[:3, 3]) for c in cams]),
        dpt=tdpt.random_params(tdpt.DPTArch.tiny_hybrid(), seed=0),
    )
    data["mono_fns"] = {
        "smooth": (lambda _p, img: smooth_mono(img, jnp),
                   lambda img: smooth_mono(img, torch)),
        None: (None, None)}
    plain = j_make_train_step(jax_cfg(), 3)
    js = JState.create(jax_gaussians(data["arrays"]))
    for _ in range(3):
        js, _ = plain(js, jax_batch(data), jnp.asarray(data["protos"]), jnp.asarray(data["bg"]),
                      jnp.float32(1.0))
    data["jax_state"] = jax.tree_util.tree_map(np.array, js)
    jmono = jde.mono_depth_from_params({k: jnp.asarray(v) for k, v in data["dpt"].items()},
                                       arch=jdpt.DPTArch.tiny_hybrid())
    data["mono_fns"]["dpt"] = (jmono.apply, tde.mono_depth_from_params(
        data["dpt"], arch=tdpt.DPTArch.tiny_hybrid(), device="cpu"))
    data["jmono_params"] = jmono.params
    data["jax_steps"] = {}
    return data


def jax_batch(data):
    cam = JCamera.create(T=TRAIN_T[0], **CAM)
    return JBatch(camera=jax.tree_util.tree_map(lambda x: x[None], cam),
                  image=jnp.asarray(data["image"]), depth_mono=jnp.asarray(data["mono"]),
                  feature=jnp.asarray(data["feature"]), seg_map=jnp.asarray(data["seg"]))


def torch_batch(data):
    return ViewBatch(cameras=[TCamera.create(T=TRAIN_T[0], **CAM, device="cpu")],
                     image=torch.from_numpy(data["image"]),
                     depth_mono=torch.from_numpy(data["mono"]),
                     feature=torch.from_numpy(data["feature"]),
                     seg_map=torch.from_numpy(data["seg"]))


def pseudo_inputs(data, fused: bool, use_jax: bool):
    R_p, t_p = np.eye(3, dtype=np.float32), PSEUDO_T.astype(np.float32)
    geo = [data["train_depths"], data["K"], data["R_train"], data["t_train"], R_p, t_p]
    if use_jax:
        geo = [jnp.asarray(a) for a in geo]
        f, w = j_reproject(*geo) if fused else (None, None)
        return JPseudo(JCamera.create(T=PSEUDO_T, **CAM), *geo, mono_params=data["jmono_params"],
                       reproj_fused=f, reproj_weight=w)
    geo = [torch.from_numpy(np.array(a)) for a in geo]
    f, w = reproject_fused_depth(*geo) if fused else (None, None)
    return PseudoInputs(TCamera.create(T=PSEUDO_T, **CAM, device="cpu"), *geo,
                        reproj_fused=f, reproj_weight=w)


def rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def pseudo_terms(state, data, case, pseudo, mono_fn):
    """The port's three pseudo terms at this state, each separately."""
    cfg = torch_cfg(case.get("seg_from_train", False))
    g = state.gaussians
    out = tstep.render(pseudo.camera, g, cfg.raster, torch.from_numpy(data["bg"]), 3,
                       device="cpu")
    with torch.no_grad():
        proto = torch.from_numpy(data["protos"])
        full = tstep._pseudo_losses(out, pseudo, proto, cfg, state.step, mono_fn)
        no_net = tstep._pseudo_losses(out, pseudo, proto, cfg, state.step, None)
        below = tstep._pseudo_losses(out, pseudo, proto, cfg, 4000, mono_fn)
    return dict(reproj=float(no_net), mono=float(below - no_net), seg=float(full - below))


@pytest.mark.parametrize("name", list(CASES))
def test_pseudo_step_matches_jax(scene, name):
    case = CASES[name]
    mono = case.get("mono", "smooth")
    j_mono_fn, mono_fn = scene["mono_fns"][mono]
    grad_tol, nu_tol, param_tol = TOLS[mono]
    fused = case.get("fused", True)
    seg_from_train = case.get("seg_from_train", False)
    key = (seg_from_train, mono)
    if key not in scene["jax_steps"]:     # cases that differ only in the step share one
        scene["jax_steps"][key] = j_make_train_step(jax_cfg(seg_from_train), 3,
                                                    with_pseudo=True, mono_depth_fn=j_mono_fn)
    jstep = scene["jax_steps"][key]
    js = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), scene["jax_state"])
    js = js.replace(step=jnp.int32(case["step"]))
    before = jax_state_arrays(js)
    js, jm = jstep(js, jax_batch(scene), jnp.asarray(scene["protos"]), jnp.asarray(scene["bg"]),
                   jnp.float32(1.0), pseudo_inputs(scene, fused, use_jax=True))
    after = jax_state_arrays(js)

    state = TrainState.from_numpy(before, device="cpu")
    assert state.step == case["step"]
    pseudo = pseudo_inputs(scene, fused, use_jax=False)
    if fused:
        assert float(pseudo.reproj_weight.sum()) > 100
    terms = pseudo_terms(state, scene, case, pseudo, mono_fn)
    print(name, {k: f"{v:.5f}" for k, v in terms.items()})
    assert terms["reproj"] != 0.0
    if mono is not None:
        assert terms["mono"] != 0.0
        assert (terms["seg"] != 0.0) == (case["step"] > 4000)

    cfg = torch_cfg(seg_from_train)
    grads = loss_and_grads(state, torch_batch(scene), torch.from_numpy(scene["protos"]),
                           torch.from_numpy(scene["bg"]), cfg, 3, torch.device("cpu"),
                           pseudo=pseudo, mono_depth_fn=mono_fn)
    step = make_train_step(cfg, 3, with_pseudo=True, mono_depth_fn=mono_fn)
    state, tm = step(state, torch_batch(scene), scene["protos"], scene["bg"], 1.0, pseudo=pseudo,
                     device="cpu")
    got = state.to_numpy()

    for k in ("loss", "l1", "psnr"):
        assert float(getattr(tm, k)) == pytest.approx(float(getattr(jm, k)), rel=1e-5), k
    for k in ("overflow", "clipped", "num_alive", "slab"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    assert float(grads.loss) == float(tm.loss)
    for k in TRAINABLE:
        g_jax = (after["mu"][k] - np.float32(0.9) * before["mu"][k]) / np.float32(0.1)
        assert rel_err(grads.params[k].numpy(), g_jax) <= grad_tol, (k, rel_err(
            grads.params[k].numpy(), g_jax))
        np.testing.assert_allclose(got["gaussians"][k], after["gaussians"][k], rtol=0,
                                   atol=param_tol, err_msg=k)
        assert rel_err(got["mu"][k], after["mu"][k]) <= grad_tol, k
        assert rel_err(got["nu"][k], after["nu"][k]) <= nu_tol, k
    for k in STAT_FIELDS:
        assert rel_err(got["stats"][k], after["stats"][k]) <= 1e-4, k
    for k in ("step", "adam_step", "max_overflow", "max_clipped", "max_slab"):
        assert got[k] == after[k], k


def test_pseudo_step_needs_its_inputs(scene):
    """A pseudo step refuses to run without PseudoInputs, and a plain step
    refuses them."""
    state = TrainState.from_numpy(jax_state_arrays(scene["jax_state"]), device="cpu")
    pseudo = pseudo_inputs(scene, True, use_jax=False)
    args = (state, torch_batch(scene), scene["protos"], scene["bg"], 1.0)
    with pytest.raises(ValueError, match="PseudoInputs"):
        make_train_step(torch_cfg(), 3, with_pseudo=True)(*args, device="cpu")
    with pytest.raises(ValueError, match="PseudoInputs"):
        make_train_step(torch_cfg(), 3)(*args, pseudo=pseudo, device="cpu")
