"""A run of pseudo steps with a random-weight depth net in bf16, the port
against sdpgs_tpu, on the CPU.

With random weights the depth net's term is noise to the photometric
loss: it slows L1's fall. This holds the port's L1 to the JAX package's,
step by step, over STEPS pseudo steps from the same state (iteration
4500, every pseudo term live) with the tiny_hybrid DPT (seed 0) in bf16,
the config default: a fault of the port's bf16 backward would part the
two runs. A trained-like cloud is rendered from 3 train cameras for the
targets and the trainee is a perturbed copy; the pseudo cameras come from
``generate_random_poses_llff`` around the train cameras, and each package
fuses its own reprojection z-buffers. L1 agrees to 1e-3 relative per step
(bf16 rounds in another order in each package; measured 3.2e-4); the
same steps without the depth net, on the port, bring L1 further down."""

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
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.core.sh import rgb_to_sh
from sdpgs_torch.data.pose_sampling import generate_random_poses_llff
from sdpgs_torch.losses import reproject_fused_depth
from sdpgs_torch.models import depth_estimator as tde
from sdpgs_torch.models import dpt as tdpt
from sdpgs_torch.render import render
from sdpgs_torch.train.state import TrainState
from sdpgs_torch.train.step import PseudoInputs, ViewBatch, make_train_step
from test_torch_core import jax_gaussians

W, H, S = 126, 94, 16
P, N_ALIVE = 1 << 13, 4000
STEPS = 9
CAM = dict(fovx=0.9, fovy=0.7, width=W, height=H)
TRAIN_T = [np.array([0.1 * i - 0.1, 0.0, 0.0]) for i in range(3)]
L1_RTOL = 1e-3


def cloud(rng) -> dict:
    """A trained-like cloud: N_ALIVE live slots of P, the rest dead."""
    K = 16
    n = N_ALIVE
    quat = rng.normal(size=(n, 4))
    live = dict(
        xyz=rng.normal(size=(n, 3)) * [1.2, 0.9, 0.6] + [0.0, 0.0, 4.0],
        features_dc=rgb_to_sh(rng.uniform(size=(n, 1, 3))),
        features_rest=rng.normal(size=(n, K - 1, 3)) * 0.05,
        scaling=np.log(0.01) + rng.normal(size=(n, 3)) * 0.3,
        rotation=quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        opacity=rng.uniform(-2.0, 3.0, size=(n, 1)),
        language_feature=rng.normal(size=(n, 3)))
    fill = dict(scaling=-10.0, opacity=-10.0)
    out = {}
    for k, v in live.items():
        a = np.full((P,) + v.shape[1:], fill.get(k, 0.0), np.float32)
        a[:n] = v
        out[k] = a
    out["rotation"][n:, 0] = 1.0
    out["alive"] = (np.arange(P) < n).astype(np.float32)
    out["confidence"] = np.ones((P, 1), np.float32)
    return out


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    gt = cloud(rng)
    cams = [TCamera.create(R=np.eye(3), T=t, **CAM, device="cpu") for t in TRAIN_T]
    g = Gaussians.from_numpy(gt, device="cpu")
    with torch.no_grad():
        outs = [render(c, g, tconfig.RasterizeConfig(), torch.zeros(3), 3, device="cpu")
                for c in cams]
    trainee = {k: v.copy() for k, v in gt.items()}
    trainee["xyz"][:N_ALIVE] += rng.normal(size=(N_ALIVE, 3)).astype(np.float32) * 0.01
    trainee["opacity"][:N_ALIVE] -= 2.0
    trainee["features_dc"][:N_ALIVE] += rng.normal(size=(N_ALIVE, 1, 3)).astype(np.float32) * 0.2
    depths = np.stack([o.depth.numpy() for o in outs])
    bounds = np.stack([np.percentile(d[d > 0], [1.0, 99.0]) for d in depths])
    poses = generate_random_poses_llff([np.eye(3)] * 3, TRAIN_T, bounds, n_poses=STEPS,
                                       rng=np.random.default_rng(2))
    return dict(
        trainee=trainee,
        image=np.stack([o.color.permute(2, 0, 1).numpy() for o in outs]),
        depth=depths,
        feature=np.stack([o.feature.permute(2, 0, 1).numpy() for o in outs]),
        seg=rng.integers(0, S, size=(3, H, W)).astype(np.int32),
        protos=rng.normal(size=(S, 3)).astype(np.float32),
        K=cams[0].intrinsics_matrix().numpy(),
        R_train=np.stack([c.view[:3, :3].numpy() for c in cams]),
        t_train=np.stack([c.view[:3, 3].numpy() for c in cams]),
        pseudo_RT=[(p[:3, :3].T, p[:3, 3]) for p in poses],
        dpt=tdpt.random_params(tdpt.DPTArch.tiny_hybrid(), seed=0),
    )


def jax_l1s(data) -> list:
    cfg = jconfig.TrainConfig()
    cfg.raster = jconfig.RasterizeConfig(use_pallas=False, use_rank_kernel=False)
    mono = jde.mono_depth_from_params({k: jnp.asarray(v) for k, v in data["dpt"].items()},
                                      arch=jdpt.DPTArch.tiny_hybrid(), dtype=jnp.bfloat16)
    step = j_make_train_step(cfg, 3, with_pseudo=True, mono_depth_fn=mono.apply)
    js = JState.create(jax_gaussians(data["trainee"])).replace(step=jnp.int32(4500))
    geo = [jnp.asarray(data[k]) for k in ("depth", "K", "R_train", "t_train")]
    l1s = []
    for i in range(STEPS):
        v = i % 3
        cam = JCamera.create(R=np.eye(3), T=TRAIN_T[v], **CAM)
        batch = JBatch(camera=jax.tree_util.tree_map(lambda x: x[None], cam),
                       image=jnp.asarray(data["image"][v:v + 1]),
                       depth_mono=jnp.asarray(data["depth"][v:v + 1]),
                       feature=jnp.asarray(data["feature"][v:v + 1]),
                       seg_map=jnp.asarray(data["seg"][v:v + 1]))
        R, T = data["pseudo_RT"][i]
        pcam = JCamera.create(R=R, T=T, **CAM)
        R_p, t_p = pcam.view[:3, :3], pcam.view[:3, 3]
        f, w = j_reproject(*geo, R_p, t_p)
        pseudo = JPseudo(pcam, *geo, R_p, t_p, mono_params=mono.params, reproj_fused=f,
                         reproj_weight=w)
        js, m = step(js, batch, jnp.asarray(data["protos"]), jnp.zeros(3), jnp.float32(1.0),
                     pseudo)
        l1s.append(float(m.l1))
    return l1s


def torch_l1s(data, mono) -> list:
    step = make_train_step(tconfig.TrainConfig(), 3, with_pseudo=True, mono_depth_fn=mono)
    state = TrainState.create(Gaussians.from_numpy(data["trainee"], device="cpu"), device="cpu")
    state.step = 4500
    geo = [torch.from_numpy(data[k]) for k in ("depth", "K", "R_train", "t_train")]
    l1s = []
    for i in range(STEPS):
        v = i % 3
        batch = ViewBatch(cameras=[TCamera.create(R=np.eye(3), T=TRAIN_T[v], **CAM, device="cpu")],
                          image=torch.from_numpy(data["image"][v:v + 1]),
                          depth_mono=torch.from_numpy(data["depth"][v:v + 1]),
                          feature=torch.from_numpy(data["feature"][v:v + 1]),
                          seg_map=torch.from_numpy(data["seg"][v:v + 1]))
        R, T = data["pseudo_RT"][i]
        pcam = TCamera.create(R=R, T=T, **CAM, device="cpu")
        R_p, t_p = pcam.view[:3, :3], pcam.view[:3, 3]
        f, w = reproject_fused_depth(*geo, R_p, t_p)
        pseudo = PseudoInputs(pcam, *geo, R_p, t_p, reproj_fused=f, reproj_weight=w)
        state, m = step(state, batch, data["protos"], np.zeros(3, np.float32), 1.0,
                        pseudo=pseudo, device="cpu")
        l1s.append(float(m.l1))
    return l1s


def fall(l1s) -> float:
    """Mean L1 of the last cycle of the 3 train cameras over the first's."""
    return float(np.mean(l1s[-3:]) / np.mean(l1s[:3]))


def test_pseudo_steps_with_random_bf16_net_follow_jax(scene):
    mono = tde.mono_depth_from_params(scene["dpt"], arch=tdpt.DPTArch.tiny_hybrid(),
                                      dtype=torch.bfloat16, device="cpu")
    got = torch_l1s(scene, mono)
    ref = jax_l1s(scene)
    no_net = torch_l1s(scene, None)
    rel = np.abs(np.array(got) - ref) / np.array(ref)
    print(f"L1 per step, port {np.round(got, 5).tolist()}, JAX {np.round(ref, 5).tolist()}, "
          f"largest relative difference {rel.max():.2e}; L1 falls to {fall(got):.4f} (JAX "
          f"{fall(ref):.4f}) of its start with the net, {fall(no_net):.4f} without")
    assert rel.max() <= L1_RTOL
    assert fall(no_net) < fall(got) < 1.0
