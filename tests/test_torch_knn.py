"""The port's k-NN (ops/knn.py) and create_from_points without init_scale
against sdpgs_tpu, on the CPU.

The same numpy points go through JAX's ``knn`` / ``mean_sq_dist_to_knn``
and the port's. The port forms |q|^2 - 2 q.p + |p|^2 as XLA does (the
product by one matmul, the norms as a chain of fused multiply-adds), so
the distances are held bit for bit and the indices exactly, ties
included: duplicated points tie exactly, and both packages then list the
lower index first. ``create_from_points`` without ``init_scale`` is held to
JAX's at atol 1e-6 on every field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.core import gaussians as jgaussians
from sdpgs_tpu.ops import knn as jknn
from sdpgs_torch.core import gaussians as tgaussians
from sdpgs_torch.ops import knn as tknn

CASES = {
    # N not a multiple of chunk, a dead-point mask
    "masked_ragged": dict(n=300, chunk=128, dead=0.2),
    "no_mask": dict(n=256, chunk=64, dead=None),
    # groups of exact duplicates: tied distances, resolved by index
    "duplicates": dict(n=200, chunk=96, dead=0.1, dup=True),
}


def points(rng, n, dup=False):
    pts = (rng.normal(size=(n, 3)) * 0.4 + [0.0, 0.0, 3.0]).astype(np.float32)
    if dup:
        pts[1::4] = pts[0::4][:len(pts[1::4])]
        pts[2::4] = pts[0::4][:len(pts[2::4])]
    return pts


@pytest.mark.parametrize("name", list(CASES))
def test_knn_matches_jax(name):
    case = CASES[name]
    rng = np.random.default_rng(0)
    pts = points(rng, case["n"], case.get("dup", False))
    mask = None if case["dead"] is None else (rng.random(case["n"]) > case["dead"]).astype(
        np.float32)
    jd, ji = jknn.knn(jnp.asarray(pts), k=3, mask=None if mask is None else jnp.asarray(mask),
                      chunk=case["chunk"])
    td, ti = tknn.knn(torch.from_numpy(pts), k=3,
                      mask=None if mask is None else torch.from_numpy(mask),
                      chunk=case["chunk"], device="cpu")
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if case.get("dup"):    # the exact ties were reached
        assert (td.numpy()[:, 0] == td.numpy()[:, 1]).sum() > 20
    jm = jknn.mean_sq_dist_to_knn(jnp.asarray(pts), k=3,
                                  mask=None if mask is None else jnp.asarray(mask))
    tm = tknn.mean_sq_dist_to_knn(torch.from_numpy(pts), k=3,
                                  mask=None if mask is None else torch.from_numpy(mask),
                                  device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_knn_refuses_a_device_mismatch():
    with pytest.raises(ValueError, match="live on"):
        tknn.knn(torch.zeros((8, 3)), device="meta")


@pytest.mark.parametrize("dup", [False, True])
def test_create_from_points_without_init_scale_matches_jax(dup):
    rng = np.random.default_rng(1)
    pts = points(rng, 150, dup)
    cols = rng.uniform(size=(150, 3)).astype(np.float32)
    jg = jgaussians.create_from_points(pts, cols, 192)
    tg = tgaussians.create_from_points(pts, cols, 192, device="cpu")
    got = tg.to_numpy()
    for k in tgaussians.PARAM_FIELDS + tgaussians.BUFFER_FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jg, k)), rtol=0, atol=1e-6,
                                   err_msg=k)
