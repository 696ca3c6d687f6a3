"""Gradients of the port's preprocess + SH (autograd through the plain
version of K1, which is the plain version of K4) against sdpgs_tpu: the
vjp of the Pallas kernel pair in interpret mode (preprocess_pallas.py:
251-281, a traced jax.vjp of the same row math) and JAX autodiff of the XLA
path (preprocess_fused + colors_from_sh). Inputs hold Gaussians behind the
camera and inside the near plane, at and past the clip limits, and with
negative pre-clamp colour. Tolerance: 1e-5 of each field's largest
gradient (float32 evaluation of the same formulas in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.core import sh as jsh
from sdpgs_tpu.core.camera import Camera as JCamera
from sdpgs_tpu.ops.rasterize import preprocess as jpre
from sdpgs_tpu.ops.rasterize.preprocess_pallas import preprocess_color_pallas
from sdpgs_torch import _kernels
from sdpgs_torch.core.camera import Camera as TCamera
from sdpgs_torch.ops.rasterize import preprocess_cuda

P = 512
CAM = dict(R=np.eye(3), T=np.array([0.05, -0.02, 0.0]), fovx=0.9, fovy=0.7,
           width=96, height=64)
TOL = 1e-5


@pytest.fixture
def inputs(rng):
    xyz = rng.normal(size=(P, 3)) * 0.5 + [0.0, 0.0, 3.0]
    scale = rng.uniform(0.01, 0.1, size=(P, 3))
    quat = rng.normal(size=(P, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    features = rng.normal(size=(P, 16, 3)) * 0.3
    alive = (rng.random(P) > 0.1).astype(np.float64)
    xyz[:5, 2] = -1.0                          # behind the camera
    xyz[5:8] = [0.0, 0.0, 0.1]                 # in front, inside the near plane
    xyz[8:40, 0] = rng.uniform(-8.0, 8.0, 32)  # at and past the clip limits
    xyz[40:48, 1] = rng.uniform(-6.0, 6.0, 8)
    features[48:64, 0] = -3.0                  # negative pre-clamp colour
    cot = rng.normal(size=(P, 9))              # mean2d(2) depth conic(3) color(3)
    return [a.astype(np.float32) for a in (xyz, scale, quat, features, alive, cot)]


def _loss_terms(mean2d, depth, conic, color, cot):
    return ((mean2d * cot[:, 0:2]).sum() + (depth * cot[:, 2]).sum()
            + (conic * cot[:, 3:6]).sum() + (color * cot[:, 6:9]).sum())


def port_grads(inputs, deg):
    xyz, scale, quat, features, alive, cot = (torch.from_numpy(a) for a in inputs)
    args = [t.clone().requires_grad_() for t in (xyz, scale, quat, features)]
    cam = TCamera.create(**CAM, device="cpu")
    prep, color = preprocess_cuda.preprocess_color(*args, alive, cam, deg)
    _loss_terms(prep.mean2d, prep.depth, prep.conic, color, cot).backward()
    return [a.grad.numpy() for a in args]


def assert_grads_match(got, ref):
    for g, r, name in zip(got, ref, ("xyz", "scale", "quat", "features")):
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(g - r).max() <= TOL * scale, (name, np.abs(g - r).max() / scale)


@pytest.mark.parametrize("deg", [0, 3])
def test_grads_match_pallas_interpret(inputs, deg):
    xyz, scale, quat, features, alive, cot = (jnp.asarray(a) for a in inputs)
    cam = JCamera.create(**CAM)

    def loss(xyz, scale, quat, features):
        prep, color = preprocess_color_pallas(xyz, scale, quat, features, alive, cam, deg,
                                              interpret=True)
        return _loss_terms(prep.mean2d, prep.depth, prep.conic, color, cot)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(xyz, scale, quat, features)
    got = port_grads(inputs, deg)
    assert not np.any(got[3][:, (deg + 1) ** 2:])            # unused SH rows
    assert_grads_match(got, ref)


@pytest.mark.parametrize("deg", [0, 3])
def test_grads_match_xla_autodiff(inputs, deg):
    xyz, scale, quat, features, alive, cot = (jnp.asarray(a) for a in inputs)
    cam = JCamera.create(**CAM)

    def loss(xyz, scale, quat, features):
        prep = jpre.preprocess_fused(xyz, scale, quat, cam, alive)
        dirs = xyz - cam.cam_pos[None, :]
        dirs = dirs / jnp.sqrt(jnp.sum(dirs * dirs, -1, keepdims=True) + 1e-24)
        color = jnp.maximum(jsh.eval_sh(deg, features, dirs) + 0.5, 0.0)
        return _loss_terms(prep.mean2d, prep.depth, prep.conic, color, cot)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(xyz, scale, quat, features)
    assert_grads_match(port_grads(inputs, deg), ref)


def test_color_gradient_reaches_xyz(inputs):
    """Cotangents on the rgb rows alone still move xyz, through the
    normalized SH view direction; a clamped channel passes none."""
    xyz, scale, quat, features, alive, _ = inputs
    geoT, shT = preprocess_cuda.pack_rows(*(torch.from_numpy(a) for a in inputs[:5]), 3)
    cam_vec = preprocess_cuda._cam_vec(TCamera.create(**CAM, device="cpu"))
    ct = torch.zeros((preprocess_cuda.NOUT, P))
    ct[8:11] = 1.0
    dgeo, dsh = preprocess_cuda.preprocess_vjp_plain(geoT, shT, cam_vec, ct, 3, 96, 64)
    moved = dgeo[0:3].abs().sum(dim=0) > 0
    rows = torch.stack(preprocess_cuda._row_math(geoT, shT, cam_vec, deg=3, width=96,
                                                 height=64, near=0.2, low_pass=0.3))
    lit = (rows[8:11] > 0).any(dim=0)
    assert bool(torch.equal(moved, lit))
    assert float(dgeo[3:10].abs().max()) == 0.0     # colour does not depend on scale/quat
    assert not bool((rows[8:11] > 0).all())         # some channels are clamped


def test_plain_vjp_and_masks(inputs):
    """preprocess_vjp_plain is autograd's vjp of the rows, and
    row_masks_plain reports the step functions the inputs straddle."""
    geoT, shT = preprocess_cuda.pack_rows(*(torch.from_numpy(a) for a in inputs[:5]), 3)
    cam_vec = preprocess_cuda._cam_vec(TCamera.create(**CAM, device="cpu"))
    ct = torch.from_numpy(np.random.default_rng(3).normal(
        size=(preprocess_cuda.NOUT, P)).astype(np.float32))
    _kernels.reset_counts()
    dgeo, dsh = preprocess_cuda.preprocess_vjp_plain(geoT, shT, cam_vec, ct, 3, 96, 64)
    assert _kernels.PLAIN_CALLS["preprocess_bwd"] == 1
    g, s = geoT.clone().requires_grad_(), shT.clone().requires_grad_()
    rows = preprocess_cuda.preprocess_rows(g, s, cam_vec, 3, 96, 64)
    (rows * ct).sum().backward()
    np.testing.assert_array_equal(dgeo.numpy(), g.grad.numpy())
    np.testing.assert_array_equal(dsh.numpy(), s.grad.numpy())
    assert float(dgeo[10].abs().max()) == 0.0       # alive carries no gradient
    word = preprocess_cuda.row_masks_plain(geoT, shT, cam_vec, 3, 96, 64)
    clip = preprocess_cuda.MASK_CLIP_X
    rgb0 = preprocess_cuda.MASK_RGB0
    assert int(((word & clip) == 0).sum()) > 0 and int(((word & clip) != 0).sum()) > P // 2
    assert int(((word & rgb0) == 0).sum()) > 0
    assert int((word & preprocess_cuda.MASK_DET_ZERO).sum()) == 0
