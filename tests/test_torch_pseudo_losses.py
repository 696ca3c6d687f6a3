"""The pseudo view's losses and poses against sdpgs_tpu's, on the CPU:
segment_cluster_assign (labels exact), segment_pearson_loss,
seg_norm_mse_loss and loss_depth_smoothness with their gradients (1e-5
relative on values, 1e-4 of the largest gradient: the same float32
formulas, sums in another order), and generate_random_poses_llff (the
same numpy code and generator: equal to 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.data import pose_sampling as jposes
from sdpgs_tpu.losses import depth as jdepth
from sdpgs_tpu.losses import feature as jfeature
from sdpgs_torch.data import pose_sampling as tposes
from sdpgs_torch.losses import depth as tdepth
from sdpgs_torch.losses import feature as tfeature

H, W, S = 30, 41, 6


@pytest.mark.parametrize("window", [7, 3])
def test_segment_cluster_assign_matches_jax(rng, window):
    feat = rng.normal(size=(3, H, W)).astype(np.float32)
    feat[:, :5, :5] = 0.0                    # background pixels: zero features
    protos = rng.normal(size=(S, 3)).astype(np.float32)
    got = tfeature.segment_cluster_assign(torch.from_numpy(feat), torch.from_numpy(protos),
                                          window)
    ref = np.asarray(jfeature.segment_cluster_assign(jnp.asarray(feat), jnp.asarray(protos),
                                                     window))
    assert got.dtype == torch.int32 and got.shape == (H, W)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1


def _value_and_grads(jfn, tfn, *arrays, argnums=(0, 1)):
    j_val, j_grads = jax.value_and_grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(i in argnums) for i, a in enumerate(arrays)]
    val = tfn(*ts)
    grads = torch.autograd.grad(val, [ts[i] for i in argnums])
    assert float(val.detach()) == pytest.approx(float(j_val), rel=1e-5)
    for g, jg in zip(grads, j_grads):
        jg = np.asarray(jg)
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()
    return float(val.detach())


@pytest.mark.parametrize("case", ["random", "empty_and_constant"])
@pytest.mark.parametrize("fn", ["segment_pearson_loss", "seg_norm_mse_loss"])
def test_segment_pearson_matches_jax(rng, fn, case):
    depth = rng.uniform(1, 5, size=(H, W)).astype(np.float32)
    mono = (rng.uniform(0, 1, size=(H, W)) - 0.3 * depth).astype(np.float32)
    labels = rng.integers(0, S, size=(H, W)).astype(np.int32)
    if case == "empty_and_constant":
        labels[labels == 2] = 1              # segment 2 empty
        labels[0, 0] = 5
        labels[labels == 5] = 3              # segment 5 empty
        depth[labels == 4] = 2.0             # segment 4 constant in depth
    lab_t = torch.from_numpy(labels)
    val = _value_and_grads(
        lambda d, m: getattr(jdepth, fn)(d, m, jnp.asarray(labels), S),
        lambda d, m: getattr(tdepth, fn)(d, m, lab_t, S), depth, mono)
    assert val != 0.0


def test_loss_depth_smoothness_matches_jax(rng):
    depth = rng.uniform(1, 5, size=(1, H, W)).astype(np.float32)
    img = rng.uniform(size=(3, H, W)).astype(np.float32)
    val = _value_and_grads(jdepth.loss_depth_smoothness, tdepth.loss_depth_smoothness, depth, img)
    assert val > 0.0


def test_generate_random_poses_llff_matches_jax(rng):
    Rs, Ts = [], []
    for i in range(3):
        a = 0.05 * (i - 1)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]))
        Ts.append(np.array([0.1 * i - 0.1, 0.02 * i, 0.0]))
    bounds = np.array([[2.0, 7.0], [2.2, 6.5], [1.9, 7.5]])
    got = tposes.generate_random_poses_llff(Rs, Ts, bounds, n_poses=50,
                                            rng=np.random.default_rng(4))
    ref = jposes.generate_random_poses_llff(Rs, Ts, bounds, n_poses=50,
                                            rng=np.random.default_rng(4))
    assert got.shape == (50, 4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    rot = got[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-9)
