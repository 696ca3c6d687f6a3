"""sdpgs_torch core against sdpgs_tpu on the same numpy inputs: cameras,
SH, transforms, Gaussian activations and carry-over, PLY in both
directions, config JSON in both directions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu import config as jconfig
from sdpgs_tpu.core import camera as jcamera
from sdpgs_tpu.core import gaussians as jgaussians
from sdpgs_tpu.core import sh as jsh
from sdpgs_tpu.core import transforms as jtransforms
from sdpgs_tpu.data import ply as jply
from sdpgs_torch import config as tconfig
from sdpgs_torch.core import camera as tcamera
from sdpgs_torch.core import gaussians as tgaussians
from sdpgs_torch.core import sh as tsh
from sdpgs_torch.core import transforms as ttransforms
from sdpgs_torch.data import ply as tply

CPU = "cpu"


def random_arrays(rng, P=96, n=80, deg=3):
    """JAX-field-keyed Gaussian parameters: n alive slots, then dead slots
    filled as the PLY loader fills them."""
    K = (deg + 1) ** 2
    a = dict(
        xyz=np.zeros((P, 3)), features_dc=np.zeros((P, 1, 3)),
        features_rest=np.zeros((P, K - 1, 3)), scaling=np.full((P, 3), -10.0),
        rotation=np.tile([1.0, 0.0, 0.0, 0.0], (P, 1)), opacity=np.full((P, 1), -10.0),
        language_feature=np.zeros((P, 3)),
        alive=(np.arange(P) < n).astype(np.float64), confidence=np.ones((P, 1)),
    )
    a["xyz"][:n] = rng.normal(size=(n, 3)) * [0.5, 0.4, 0.3] + [0, 0, 3.0]
    a["features_dc"][:n] = rng.normal(size=(n, 1, 3)) * 0.5
    a["features_rest"][:n] = rng.normal(size=(n, K - 1, 3)) * 0.1
    a["scaling"][:n] = np.log(0.03) + rng.normal(size=(n, 3)) * 0.3
    a["rotation"][:n] = rng.normal(size=(n, 4))
    a["opacity"][:n] = rng.uniform(-2, 3, size=(n, 1))
    a["language_feature"][:n] = rng.normal(size=(n, 3))
    return {k: v.astype(np.float32) for k, v in a.items()}


def jax_gaussians(arrays, deg=3):
    return jgaussians.Gaussians(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                max_sh_degree=deg)


def random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("case", ["identity", "rotated", "recentred"])
def test_camera_bit_equal(rng, case):
    R = np.eye(3) if case == "identity" else random_rotation(rng)
    T = rng.normal(size=3)
    kw = dict(fovx=0.9, fovy=0.7, width=504, height=378)
    if case == "recentred":
        kw.update(translate=rng.normal(size=3), scale=1.3)
    cj = jcamera.Camera.create(R=R, T=T, **kw)
    ct = tcamera.Camera.create(R=R, T=T, device=CPU, **kw)
    for name in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy",
                 "focal_x", "focal_y"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)), err_msg=name)
    np.testing.assert_array_equal(ct.intrinsics_matrix().numpy(),
                                  np.asarray(cj.intrinsics_matrix()))
    assert (ct.width, ct.height) == (cj.width, cj.height)
    carried = tcamera.Camera.from_numpy(
        {f: np.asarray(getattr(cj, f)) for f in
         ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy", "height", "width")},
        device=CPU)
    np.testing.assert_array_equal(carried.full_proj.numpy(), np.asarray(cj.full_proj))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches(rng, deg):
    sh = rng.normal(size=(64, 16, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    got = tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), atol=1e-6)


def test_transforms_match(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.2, size=(50, 3)).astype(np.float32)
    qn_j = jtransforms.normalize_quat(jnp.asarray(q))
    qn_t = ttransforms.normalize_quat(torch.from_numpy(q))
    np.testing.assert_allclose(qn_t.numpy(), np.asarray(qn_j), atol=1e-6)
    np.testing.assert_allclose(ttransforms.quat_to_rotmat(qn_t).numpy(),
                               np.asarray(jtransforms.quat_to_rotmat(qn_j)), atol=1e-6)
    np.testing.assert_allclose(
        ttransforms.build_covariance_3d(torch.from_numpy(s), qn_t, 1.5).numpy(),
        np.asarray(jtransforms.build_covariance_3d(jnp.asarray(s), qn_j, 1.5)), atol=1e-6)
    x = rng.uniform(0.01, 0.99, size=20).astype(np.float32)
    np.testing.assert_allclose(ttransforms.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jtransforms.inverse_sigmoid(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_activations_match(rng):
    arrays = random_arrays(rng)
    gj, gt = jax_gaussians(arrays), tgaussians.Gaussians.from_numpy(arrays, device=CPU)
    cam = np.array([0.1, -0.2, 0.0], np.float32)
    pairs = [
        (gt.get_scaling(), gj.get_scaling()),
        (gt.get_rotation(), gj.get_rotation()),
        (gt.get_opacity(), gj.get_opacity()),
        (gt.get_features(), gj.get_features()),
        (gt.get_covariance(), gj.get_covariance()),
        (gt.colors_from_sh(torch.from_numpy(cam), 3), gj.colors_from_sh(jnp.asarray(cam), 3)),
        (gt.language_feature_normalized(), gj.language_feature_normalized()),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    assert gt.num_alive() == int(gj.num_alive())


def test_from_numpy_carry_over_exact(rng):
    arrays = random_arrays(rng)
    gt = tgaussians.Gaussians.from_numpy(arrays, device=CPU)
    assert {n for n, _ in gt.named_parameters()} == set(tgaussians.PARAM_FIELDS)
    assert {n for n, _ in gt.named_buffers()} == set(tgaussians.BUFFER_FIELDS)
    back = gt.to_numpy()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert gt.capacity == 96 and gt.max_sh_degree == 3


def test_create_from_points_matches(rng):
    n, cap = 40, 64
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    init = rng.uniform(1e-4, 1e-2, size=n)
    gj = jgaussians.create_from_points(pts, cols, cap, init_scale=init)
    gt = tgaussians.create_from_points(pts, cols, cap, init_scale=init, device=CPU)
    for k, v in gt.to_numpy().items():
        np.testing.assert_allclose(v, np.asarray(getattr(gj, k)), rtol=1e-6, atol=0, err_msg=k)
    # without init_scale both compute it with their k-NN
    gj = jgaussians.create_from_points(pts, cols, cap)
    gt = tgaussians.create_from_points(pts, cols, cap, device=CPU)
    for k, v in gt.to_numpy().items():
        np.testing.assert_allclose(v, np.asarray(getattr(gj, k)), rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("deg", [1, 3])
def test_ply_jax_to_torch_exact(rng, tmp_path, deg):
    arrays = random_arrays(rng, deg=deg)
    path = tmp_path / "jax.ply"
    jply.save_gaussians_ply(path, jax_gaussians(arrays, deg))
    gt = tply.load_gaussians_ply(path, 96, deg, device=CPU)
    ref = jply.load_gaussians_ply(path, 96, deg)
    for k, v in gt.to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), err_msg=k)
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def test_ply_torch_to_jax_exact(rng, tmp_path):
    arrays = random_arrays(rng)
    path = tmp_path / "torch.ply"
    tply.save_gaussians_ply(path, tgaussians.Gaussians.from_numpy(arrays, device=CPU))
    gj = jply.load_gaussians_ply(path, 96, 3)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(gj, k)), v, err_msg=k)
    assert tply.read_ply(path).keys() == jply.read_ply(path).keys()


def test_config_round_trips_both_ways(tmp_path):
    cfg_t = tconfig.TrainConfig(raster=tconfig.RasterizeConfig(tile=16, max_per_tile=256),
                                seed=7)
    tconfig.save_config(cfg_t, tmp_path / "t.json")
    cfg_j = jconfig.load_config(tmp_path / "t.json")
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    jconfig.save_config(jconfig.TrainConfig(), tmp_path / "j.json")
    assert dataclasses.asdict(tconfig.load_config(tmp_path / "j.json")) == \
        dataclasses.asdict(jconfig.TrainConfig())
