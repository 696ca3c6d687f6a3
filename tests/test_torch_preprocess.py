"""The port's preprocess + SH (the payload entry's plain version of kernel
K1, read back from its payload columns and binning record, and the plain
preprocess paths) against sdpgs_tpu: XLA preprocess_fused + colors_from_sh
and the Pallas preprocess kernel in interpret mode. valid and radius must
be identical; float rows agree to rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.core import sh as jsh
from sdpgs_tpu.core.camera import Camera as JCamera
from sdpgs_tpu.core.transforms import build_covariance_3d as j_cov3d
from sdpgs_tpu.ops.rasterize import preprocess as jpre
from sdpgs_tpu.ops.rasterize.preprocess_pallas import preprocess_color_pallas
from sdpgs_torch import _kernels
from sdpgs_torch.core.camera import Camera as TCamera
from sdpgs_torch.core.transforms import build_covariance_3d as t_cov3d
from sdpgs_torch.ops.rasterize import payload
from sdpgs_torch.ops.rasterize import preprocess as tpre
from sdpgs_torch.ops.rasterize import preprocess_cuda

P = 1024
CAM = dict(R=np.eye(3), T=np.array([0.05, -0.02, 0.0]), fovx=0.9, fovy=0.7,
           width=96, height=64)


@pytest.fixture
def inputs(rng):
    xyz = rng.normal(size=(P, 3)).astype(np.float32) * 0.5 + [0, 0, 3.0]
    scale = rng.uniform(0.01, 0.1, size=(P, 3)).astype(np.float32)
    quat = rng.normal(size=(P, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    features = rng.normal(size=(P, 16, 3)).astype(np.float32) * 0.3
    alive = (rng.random(P) > 0.1).astype(np.float32)
    xyz[:5, 2] = -1.0          # behind the camera
    xyz[5:8] = [0.0, 0.0, 0.1]  # in front of it but inside the near plane
    return xyz.astype(np.float32), scale, quat, features, alive


def torch_rows(inputs, deg):
    """The entry's payload and binning record as (Preprocessed, color)."""
    xyz, scale, quat, features, alive = (torch.from_numpy(a) for a in inputs)
    cam = TCamera.create(**CAM, device="cpu")
    pay = preprocess_cuda.preprocess_payload(
        xyz, scale, quat, features[:, :1].contiguous(), features[:, 1:].contiguous(), alive,
        torch.ones(P), torch.zeros((P, 3)), cam, deg)
    rows, screen = pay.rows[:P], pay.screen
    np.testing.assert_array_equal(rows[:, payload.MEAN2D].numpy(), screen.mean2d.numpy())
    np.testing.assert_array_equal(rows[:, payload.DEPTH].numpy(), screen.depth.numpy())
    prep = tpre.Preprocessed(valid=screen.valid, mean2d=screen.mean2d, depth=screen.depth,
                             conic=rows[:, payload.CONIC], radius=screen.radius)
    return prep, rows[:, payload.RGB]


def assert_prep_matches(prep, color, ref_prep, ref_color):
    np.testing.assert_array_equal(prep.valid.numpy(), np.asarray(ref_prep.valid))
    np.testing.assert_array_equal(prep.radius.numpy(), np.asarray(ref_prep.radius))
    for name in ("mean2d", "depth", "conic"):
        np.testing.assert_allclose(getattr(prep, name).numpy(),
                                   np.asarray(getattr(ref_prep, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if color is not None:
        np.testing.assert_allclose(color.numpy(), np.asarray(ref_color), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_row_math_matches_xla(inputs, deg):
    xyz, scale, quat, features, alive = inputs
    cam = JCamera.create(**CAM)
    ref = jpre.preprocess_fused(jnp.asarray(xyz), jnp.asarray(scale), jnp.asarray(quat),
                                cam, jnp.asarray(alive))
    dirs = jnp.asarray(xyz) - cam.cam_pos[None, :]
    dirs = dirs / jnp.sqrt(jnp.sum(dirs * dirs, -1, keepdims=True) + 1e-24)
    ref_color = jnp.maximum(jsh.eval_sh(deg, jnp.asarray(features), dirs) + 0.5, 0.0)
    prep, color = torch_rows(inputs, deg)
    assert int(prep.valid.sum()) > P // 2 and not bool(prep.valid[:8].any())
    assert_prep_matches(prep, color, ref, ref_color)


def test_row_math_matches_pallas_interpret(inputs):
    cam = JCamera.create(**CAM)
    ref, ref_color = preprocess_color_pallas(*(jnp.asarray(a) for a in inputs), cam, 3,
                                             interpret=True)
    prep, color = torch_rows(inputs, 3)
    assert_prep_matches(prep, color, ref, ref_color)


def test_plain_preprocess_paths_match(inputs):
    """preprocess_fused and the cov3d preprocess (the JAX XLA paths)."""
    xyz, scale, quat, _, alive = inputs
    jcam, tcam = JCamera.create(**CAM), TCamera.create(**CAM, device="cpu")
    j_in = [jnp.asarray(a) for a in (xyz, scale, quat, alive)]
    t_in = [torch.from_numpy(a) for a in (xyz, scale, quat, alive)]
    got = tpre.preprocess_fused(t_in[0], t_in[1], t_in[2], tcam, t_in[3], scale_modifier=1.5)
    ref = jpre.preprocess_fused(j_in[0], j_in[1], j_in[2], jcam, j_in[3], scale_modifier=1.5)
    assert_prep_matches(got, None, ref, None)
    got = tpre.preprocess(t_in[0], t_cov3d(t_in[1], t_in[2]), tcam, t_in[3])
    ref = jpre.preprocess(j_in[0], j_cov3d(j_in[1], j_in[2]), jcam, j_in[3])
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for name in ("mean2d", "depth", "conic", "radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_wrapper_takes_plain_version_for_cpu_tensors(inputs):
    _kernels.reset_counts()
    torch_rows(inputs, 3)
    assert _kernels.PLAIN_CALLS["preprocess"] == 1
    assert _kernels.LAUNCHES["preprocess"] == 0
    geoT, shT = preprocess_cuda.pack_rows(*(torch.from_numpy(a) for a in inputs[:4]),
                                          torch.from_numpy(inputs[4]), 3)
    assert geoT.shape == (preprocess_cuda.NGEO, P) and shT.shape == (48, P)
    assert geoT.is_contiguous() and shT.is_contiguous()
