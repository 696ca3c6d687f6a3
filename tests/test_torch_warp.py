"""The port's reprojection z-buffer (ops/warp.py, the plain version of K6)
and the reprojection losses against sdpgs_tpu's, on the CPU.

Rig of tests/test_warp_pallas.py: 3 train views, 4 pseudo cameras, 64x48,
source holes. JAX builds ``proj`` with an XLA matmul and an f32 inverse,
the port with its own association order, so a row whose u or v sits on a
rounding tie can land one pixel off: the z-buffers must agree on all but
0.1% of the pixels (the share is printed), and where both are filled the
z values within 1e-5 relative. The fused depth and weight follow at the
same share; losses and their gradients to 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.losses import depth as jdepth
from sdpgs_tpu.ops.warp_pallas import DU, warp_zbuffer_batch as j_warp_batch
from sdpgs_torch import _kernels
from sdpgs_torch.losses import depth as tdepth
from sdpgs_torch.ops import warp as twarp

PIXEL_SHARE = 1e-3    # pixels allowed to differ between the port and JAX
Z_RTOL = 1e-5


@pytest.fixture
def rig(rng):
    H, W = 48, 64
    V, B = 3, 4
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depths = rng.uniform(2.0, 6.0, size=(V, H, W)).astype(np.float32)
    depths[0, :4, :4] = 0.0          # holes in the source
    R_t = np.stack([np.eye(3, dtype=np.float32)] * V)
    t_t = np.stack([np.array([0.2 * (i - 1), 0.0, 0.0], np.float32) for i in range(V)])
    R_p = np.stack([np.eye(3, dtype=np.float32)] * B)
    t_p = np.stack([np.array([0.05 * i, 0.02 * i, 0.01], np.float32) for i in range(B)])
    return K, depths, R_t, t_t, R_p, t_p


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def compare_zbuffers(got, ref, what):
    """Share of pixels whose hole/fill or z differ, printed; z within
    Z_RTOL where both are filled and close."""
    got, ref = np.asarray(got), np.asarray(ref)
    both = (got > 0) & (ref > 0)
    close = np.isclose(got, ref, rtol=Z_RTOL, atol=0.0)
    share = float(np.mean(~close))
    print(f"{what}: {int((~close).sum())} of {got.size} pixels differ "
          f"({share:.2e}, limit {PIXEL_SHARE:g}); filled {int(both.sum())}")
    assert share <= PIXEL_SHARE, (what, share)
    return share


def test_zbuffer_batch_matches_jax(rig):
    """Against the interpret-mode Pallas kernel, and against the port's own
    single-pair path and JAX's scatter for every pair."""
    got, outl = twarp.warp_zbuffer_batch(*_t(rig[1:2]), *_t(rig[:1]), *_t(rig[2:]))
    K, depths, R_t, t_t, R_p, t_p = _j(rig)
    ref, j_outl = j_warp_batch(depths, K, R_t, t_t, R_p, t_p, interpret=True)
    assert got.shape == (4, 3, 48, 64) and got.dtype == torch.float32
    assert not np.any(outl.numpy()) and not np.any(np.asarray(j_outl))
    compare_zbuffers(got.numpy(), ref, "warp_zbuffer_batch vs interpret kernel")
    Kt, dt, Rtt, ttt, Rpt, tpt = _t(rig)
    for b in range(4):
        for v in range(3):
            one = tdepth.warp_depth_to_view(dt[v], Kt, Rtt[v], ttt[v], Rpt[b], tpt[b])
            np.testing.assert_array_equal(one.numpy(), got[b, v].numpy())
            compare_zbuffers(one.numpy(), jdepth.warp_depth_to_view(
                depths[v], K, R_t[v], t_t[v], R_p[b], t_p[b]), f"pair {b},{v} vs scatter")


def test_zbuffer_outlier_geometry_matches_scatter(rng):
    """A baseline that pushes displacements past the TPU kernel's window:
    JAX counts outliers and falls back to the scatter; the port has no
    window, so it returns 0 outliers and equals the scatter."""
    H, W = 32, 256
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depths = rng.uniform(2.0, 6.0, size=(1, H, W)).astype(np.float32)
    R = np.eye(3, dtype=np.float32)[None]
    t0 = np.zeros((1, 3), np.float32)
    t_far = np.array([[8.0, 0.0, 0.0]], np.float32)
    _, j_outl = j_warp_batch(*_j((depths, K, R, t0, R, t_far)), interpret=True)
    assert int(j_outl[0]) > 0 and DU < 240
    got, outl = twarp.warp_zbuffer_batch(*_t((depths, K, R, t0, R, t_far)))
    assert int(outl[0]) == 0
    ref = jdepth.warp_depth_to_view(*_j((depths[0], K, R[0], t0[0], R[0], t_far[0])))
    assert np.count_nonzero(np.asarray(ref)) > 0
    compare_zbuffers(got[0, 0].numpy(), ref, "outlier pair vs scatter")


def test_plain_rows_are_the_kernel_contract(rig):
    """What K6 computes, row by row, from the same [proj | c] rows: every
    valid row's z is >= the z-buffer at its pixel, and the pixels no row
    reaches are the holes."""
    K, depths, R_t, t_t, R_p, t_p = _t(rig)
    pc = twarp.pair_rows(K, R_t, t_t, R_p, t_p)
    assert pc.shape == (12, 12) and pc.dtype == torch.float32
    zbuf = twarp.warp_zbuffer_rows(depths, pc)
    u, v, z, valid = twarp.project_rows(depths, pc)
    idx, zv = twarp.scatter_rows(u, v, z, valid, 48, 64)
    flat = torch.cat([zbuf.reshape(-1), torch.zeros(1)])
    hit = flat[idx[valid.reshape(-1)]]
    assert torch.all(zv[valid.reshape(-1)] >= hit)
    reached = torch.zeros(flat.shape, dtype=torch.bool)
    reached[idx[valid.reshape(-1)]] = True
    assert torch.all((flat[:-1] > 0) == reached[:-1])
    assert int(valid.sum()) > 0 and int((~valid).sum()) > 0


def test_reproject_fused_matches_jax(rig):
    K, depths, R_t, t_t, R_p, t_p = rig
    args = (depths, K, R_t, t_t, R_p, t_p)
    fb, wb, outl = tdepth.reproject_fused_depth_batch(*_t(args))
    jfb, jwb, _ = jdepth.reproject_fused_depth_batch(*_j(args), interpret=True)
    assert not np.any(outl.numpy())
    for b in range(4):
        f, w = tdepth.reproject_fused_depth(*_t((depths, K, R_t, t_t, R_p[b], t_p[b])))
        np.testing.assert_array_equal(f.numpy(), fb[b].numpy())
        np.testing.assert_array_equal(w.numpy(), wb[b].numpy())
    assert float(wb.sum()) > 0
    w_share = float(np.mean(wb.numpy() != np.asarray(jwb)))
    print(f"fused weight: share of pixels that differ from JAX {w_share:.2e}")
    assert w_share <= PIXEL_SHARE
    compare_zbuffers(fb.numpy(), jfb, "fused depth vs JAX")


@pytest.mark.parametrize("fused", [True, False], ids=["from_fused", "in_step"])
def test_reproject_losses_and_gradients_match_jax(rig, fused):
    import jax

    K, depths, R_t, t_t, R_p, t_p = rig
    rng = np.random.default_rng(5)
    rendered = rng.uniform(1.0, 7.0, size=depths.shape[1:]).astype(np.float32)
    if fused:
        f, w = jdepth.reproject_fused_depth(*_j((depths, K, R_t, t_t, R_p[1], t_p[1])))
        jfn = lambda r: jdepth.loss_reproject_from_fused(r, f, w)  # noqa: E731
        tf, tw = tdepth.reproject_fused_depth(*_t((depths, K, R_t, t_t, R_p[1], t_p[1])))
        tfn = lambda r: tdepth.loss_reproject_from_fused(r, tf, tw)  # noqa: E731
    else:
        jfn = lambda r: jdepth.loss_reproject_depth(  # noqa: E731
            r, *_j((depths, K, R_t, t_t, R_p[1], t_p[1])))
        tfn = lambda r: tdepth.loss_reproject_depth(  # noqa: E731
            r, *_t((depths, K, R_t, t_t, R_p[1], t_p[1])))
    j_loss, j_grad = jax.value_and_grad(jfn)(jnp.asarray(rendered))
    r = torch.from_numpy(rendered).requires_grad_(True)
    loss = tfn(r)
    loss.backward()
    loss = float(loss.detach())
    assert loss != 0.0
    assert loss == pytest.approx(float(j_loss), rel=1e-4)
    g = np.asarray(j_grad)
    assert np.abs(r.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max()


@pytest.mark.parametrize("bad", ["grad", "strided", "dtype", "shape", "cpu"])
def test_warp_kernel_input_checks(bad):
    """What K6's launcher refuses; a CPU tensor is refused last, so each
    other case fails for its own reason on any host."""
    depths = torch.ones((2, 8, 6)).transpose(1, 2) if bad == "strided" else torch.ones((2, 6, 8))
    depths.requires_grad_(bad == "grad")
    dtype = torch.float64 if bad == "dtype" else torch.float32
    shape = (2, 8, 6) if bad == "shape" else (2, 6, 8)
    match = {"grad": "requires grad", "strided": "contiguous", "dtype": "expected torch.float64",
             "shape": "shape", "cpu": "CUDA tensor"}[bad]
    with pytest.raises(ValueError, match=match):
        _kernels.check(depths, "depths", dtype, shape)
