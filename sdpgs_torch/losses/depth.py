"""Mono-depth prior losses.

Counterpart of ``sdpgs_tpu/losses/depth.py:19-53`` (reference
train.py:126-131, utils/loss_utils.py:309-319): the depth Pearson loss with
its disparity fallback. The reprojection and per-segment terms come with
the pseudo-view slice.
"""

from __future__ import annotations

import torch

from sdpgs_torch.losses.basic import pearson_corrcoef


def masked_pearson(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """Pearson correlation over the elements with weight w (float 0/1); the
    variance product is clamped inside the sqrt, as in pearson_corrcoef."""
    x, y, w = x.reshape(-1), y.reshape(-1), w.reshape(-1)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mx = torch.sum(x * w) / n
    my = torch.sum(y * w) / n
    xm = (x - mx) * w
    ym = (y - my) * w
    denom = torch.sqrt(torch.clamp_min(torch.sum(xm * xm) * torch.sum(ym * ym), eps * eps))
    return torch.sum(xm * ym) / denom


def depth_pearson_loss(depth: torch.Tensor, depth_mono: torch.Tensor,
                       disparity_const: float = 200.0) -> torch.Tensor:
    """min(1 - rho(mono, d), 1 - rho(1 / (c - mono), d)) (reference
    train.py:126-129; call sites pass their own disparity constant)."""
    d = depth.reshape(-1)
    m = depth_mono.reshape(-1)
    a = 1.0 - pearson_corrcoef(m, d)
    b = 1.0 - pearson_corrcoef(1.0 / (-m + disparity_const), d)
    return torch.minimum(a, b)


def loss_depth_metric(depth: torch.Tensor, depth_mono: torch.Tensor,
                      disparity_const: float = 100.0) -> torch.Tensor:
    """Masked variant restricted to mono > 0 (reference loss_utils.py:309-319)."""
    w = (depth_mono > 0).to(torch.float32)
    a = 1.0 - masked_pearson(depth_mono, depth, w)
    b = 1.0 - masked_pearson(1.0 / (-depth_mono + disparity_const), depth, w)
    return torch.minimum(a, b)
