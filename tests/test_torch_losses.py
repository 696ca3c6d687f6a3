"""The port's losses against sdpgs_tpu's on the same numpy inputs, values
and gradients, on the cases of tests/test_losses.py. Tolerances: 1e-5 on
values; gradients within 1e-4 of the largest gradient plus 1e-6 absolute,
for the cases (a constant input, a perfect fit) whose exact gradient is
zero and both packages return float32 rounding noise (sums in another
order; SSIM's Toeplitz blurs are f32 matmuls in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu import losses as jl
from sdpgs_tpu.losses.depth import masked_pearson as j_masked_pearson
from sdpgs_torch import losses as tl


def check(jfn, tfn, *arrays, n_grad=1, atol=1e-5):
    """Value and gradient (w.r.t. the first ``n_grad`` arrays) of both."""
    ref = jfn(*(jnp.asarray(a) for a in arrays))
    gref = jax.grad(lambda *xs: jfn(*xs, *(jnp.asarray(a) for a in arrays[n_grad:])),
                    argnums=tuple(range(n_grad)))(*(jnp.asarray(a) for a in arrays[:n_grad]))
    ts = [torch.tensor(a) for a in arrays]
    for t in ts[:n_grad]:
        t.requires_grad_()
    got = tfn(*ts)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), abs=atol, rel=1e-5)
    for t, g in zip(ts[:n_grad], gref):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max() + 1e-6


def images(rng, shape=(3, 40, 50)):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(size=shape).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("masked", [False, True])
def test_l1_loss_mask(rng, masked):
    a, b = images(rng)
    if masked:
        m = (rng.random((1, 40, 50)) > 0.3).astype(np.float32)
        check(jl.l1_loss_mask, tl.l1_loss_mask, a, b, m)
    else:
        check(jl.l1_loss_mask, tl.l1_loss_mask, a, b)


@pytest.mark.parametrize("shape", [(3, 40, 50), (3, 56, 72)])
def test_ssim(rng, shape):
    a, b = images(rng, shape)
    check(jl.ssim, tl.ssim, a, b, n_grad=2)


@pytest.mark.parametrize("masked", [False, True])
def test_psnr(rng, masked):
    a, b = images(rng)
    if masked:
        m = (rng.random((1, 40, 50)) > 0.3).astype(np.float32)
        check(jl.psnr, tl.psnr, a, b, m, atol=1e-4)
    else:
        check(jl.psnr, tl.psnr, a, b, atol=1e-4)


@pytest.mark.parametrize("case", ["correlated", "constant"])
def test_pearson_corrcoef(rng, case):
    x = rng.normal(size=500).astype(np.float32)
    y = (0.5 * x + rng.normal(size=500)).astype(np.float32)
    if case == "constant":     # an all-background depth: the clamp inside the
        x = np.zeros(500, np.float32)   # sqrt keeps the gradient finite
    check(jl.pearson_corrcoef, tl.pearson_corrcoef, x, y, n_grad=2)


@pytest.mark.parametrize("mono", ["random", "disparity"])
def test_depth_pearson_loss(rng, mono):
    d = rng.uniform(1, 10, (20, 30)).astype(np.float32)
    m = (rng.uniform(1, 8, (20, 30)) if mono == "random" else 200.0 - 1.0 / d).astype(np.float32)
    check(jl.depth_pearson_loss, tl.depth_pearson_loss, d, m)


def test_masked_pearson_and_depth_metric(rng):
    x = rng.normal(size=(20, 24)).astype(np.float32)
    y = (0.3 * x + rng.normal(size=(20, 24))).astype(np.float32)
    w = (rng.random((20, 24)) > 0.4).astype(np.float32)
    check(j_masked_pearson, tl.masked_pearson, x, y, w, n_grad=2)
    mono = rng.uniform(-1, 8, (20, 24)).astype(np.float32)
    check(jl.loss_depth_metric, tl.loss_depth_metric, np.abs(x) + 1, mono)


@pytest.mark.parametrize("weights", [(0.01, 1.0, 1e-6), (1.0, 0.5, 0.1)])
def test_loss_feature_metric(rng, weights):
    H, W, S = 12, 16, 5
    feat = rng.normal(size=(3, H, W)).astype(np.float32)
    feat[:, :2, :3] = 0.0                      # background pixels: smooth norm at 0
    gt = rng.normal(size=(3, H, W)).astype(np.float32)
    protos = rng.normal(size=(S, 3)).astype(np.float32)
    seg = rng.integers(0, S, (H, W)).astype(np.int32)
    fce, fl1, fsm = weights

    def total(fn):
        def f(feat, gt, protos, seg):
            lf, lsm = fn(feat, gt, protos, seg, known_fce=fce, known_fl1=fl1, known_fsm=fsm)
            return lf + lsm
        return f

    check(total(jl.loss_feature_metric), total(tl.loss_feature_metric), feat, gt, protos, seg)
    check(jl.penalty_loss, tl.penalty_loss, feat.transpose(1, 2, 0))
