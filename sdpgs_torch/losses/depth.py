"""Depth-prior losses.

Counterpart of ``sdpgs_tpu/losses/depth.py`` (reference
train.py:126-131,149-183, utils/loss_utils.py:26-60,191-200,309-384): the
mono-depth Pearson loss with its disparity fallback, the per-segment
Pearson, the edge-aware smoothness, and the multi-view reprojection
consistency with its z-buffer. The z-buffer is kernel K6 on CUDA tensors
and a ``scatter_reduce_`` on CPU tensors (``ops/warp.py``), also for a
single pair, so no CUDA tensor meets the scatter.
"""

from __future__ import annotations

import torch

from sdpgs_torch.losses.basic import pearson_corrcoef
from sdpgs_torch.ops.warp import warp_zbuffer_batch


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


def segment_pearson_loss(depth: torch.Tensor, depth_mono: torch.Tensor, labels: torch.Tensor,
                         num_segments: int, negate_mono: bool = True) -> torch.Tensor:
    """Mean over the segments present (more than one pixel) of
    1 - rho(depth_seg, -mono_seg) (reference train.py:173-178). The
    segmented sums are one-hot products, as in JAX, so they are
    deterministic on the card; sqrt's operand is sanitised before the
    root, so an empty or constant segment gives no NaN gradient."""
    d = depth.reshape(-1)
    m = (-depth_mono if negate_mono else depth_mono).reshape(-1)
    lab = labels.reshape(-1).long()
    seg = torch.arange(num_segments, device=lab.device)
    onehot = (lab[None, :] == seg[:, None]).to(torch.float32)        # [S, N]

    def seg_sum3(a, b, c):
        return onehot @ torch.stack([a, b, c], dim=-1)              # [S, 3]

    def gather(v):                                                   # v[lab], 0 outside
        return (onehot * v[:, None]).sum(dim=0)

    first = seg_sum3(torch.ones_like(d), d, m)
    cnt = first[:, 0]
    n = torch.clamp_min(cnt, 1.0)
    md = first[:, 1] / n
    mm = first[:, 2] / n
    dc = d - gather(md)
    mc = m - gather(mm)
    second = seg_sum3(dc * mc, dc * dc, mc * mc)
    present = cnt > 1.0
    prod = torch.clamp_min(torch.where(present, second[:, 1] * second[:, 2], 1.0), 1e-24)
    rho = torch.where(present, second[:, 0], 0.0) / torch.clamp_min(torch.sqrt(prod), 1e-8)
    return (torch.where(present, 1.0 - rho, 0.0).sum()
            / torch.clamp_min(present.sum().to(torch.float32), 1.0))


def seg_norm_mse_loss(pred: torch.Tensor, target: torch.Tensor, seg: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Per-segment standardised Pearson loss (reference
    loss_utils.py:94-104); the standardisation cancels inside Pearson."""
    return segment_pearson_loss(pred, target, seg, num_segments, negate_mono=True)


def loss_depth_smoothness(depth: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness (reference loss_utils.py:191-200); depth
    [1, 1, H, W] or [1, H, W], img [1, C, H, W] or [C, H, W]."""
    if depth.dim() == 3:
        depth = depth[None]
    if img.dim() == 3:
        img = img[None]
    gx = img[:, :, :, :-1] - img[:, :, :, 1:]
    gy = img[:, :, :-1, :] - img[:, :, 1:, :]
    wx = torch.exp(-torch.mean(torch.abs(gx), dim=1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(gy), dim=1, keepdim=True))
    num = (torch.sum(torch.abs(depth[:, :, :, :-1] - depth[:, :, :, 1:]) * wx)
           + torch.sum(torch.abs(depth[:, :, :-1, :] - depth[:, :, 1:, :]) * wy))
    return num / (torch.sum(wx) + torch.sum(wy))


def warp_depth_to_view(depth_ref, K, R_ref, t_ref, R_src, t_src) -> torch.Tensor:
    """Forward-warp the reference view's [H, W] depth into the target view
    with a z-buffer (scatter-min); [H, W], 0 = hole (reference
    ``tqc_from_depth`` and the z-buffer, loss_utils.py:26-60,333-353). One
    pair of :func:`~sdpgs_torch.ops.warp.warp_zbuffer_batch`; no gradient."""
    warped, _ = warp_zbuffer_batch(depth_ref[None], K, R_ref[None], t_ref[None],
                                   R_src[None], t_src[None])
    return warped[0, 0]


def _fuse_warped(warped: torch.Tensor, consistency_view_thresh: int,
                 error_range: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Average of the non-hole warps [..., V, H, W] and the view-agreement
    mask (reference loss_utils.py:354-360): ([..., H, W] fused, [..., H, W]
    0/1 weight)."""
    V = warped.shape[-3]
    zero_cnt = torch.sum(warped == 0.0, dim=-3)
    fused = torch.sum(warped, dim=-3) / (V - zero_cnt + 1e-6)
    err = torch.abs(warped - fused.unsqueeze(-3))
    agree = torch.sum(err < error_range, dim=-3)
    valid = (agree >= consistency_view_thresh) & (fused > 0)
    return fused, valid.to(torch.float32)


def reproject_fused_depth(train_depths, K, R_train, t_train, R_pseudo, t_pseudo,
                          consistency_view_thresh: int = 2, error_range: float = 0.05):
    """Warp each train view's depth [V, H, W] into the pseudo view, fuse,
    and keep the pixels where at least ``consistency_view_thresh`` views
    agree within ``error_range`` (reference loss_utils.py:321-360). Depends
    on the fixed train depths and the cameras only, never on the Gaussians.
    Returns ([H, W] fused, [H, W] 0/1 weight)."""
    warped, _ = warp_zbuffer_batch(train_depths, K, R_train, t_train, R_pseudo[None],
                                   t_pseudo[None])
    return _fuse_warped(warped[0], consistency_view_thresh, error_range)


def reproject_fused_depth_batch(train_depths, K, R_train, t_train, R_pseudo, t_pseudo,
                                consistency_view_thresh: int = 2, error_range: float = 0.05):
    """:func:`reproject_fused_depth` for B pseudo cameras (R_pseudo
    [B, 3, 3], t_pseudo [B, 3]) with one z-buffer launch for all B * V
    pairs. Returns (fused [B, H, W], weight [B, H, W], outliers [B] int32,
    always 0: the port's z-buffer has no displacement window)."""
    warped, outliers = warp_zbuffer_batch(train_depths, K, R_train, t_train, R_pseudo,
                                          t_pseudo)
    fused, weight = _fuse_warped(warped, consistency_view_thresh, error_range)
    return fused, weight, outliers


def loss_reproject_from_fused(rendered_depth: torch.Tensor, fused: torch.Tensor,
                              w: torch.Tensor, disparity_const: float = 200.0) -> torch.Tensor:
    """Pearson (with the disparity fallback) of the rendered pseudo depth
    against the fused reprojection (loss_utils.py:362-384)."""
    a = 1.0 - masked_pearson(fused, rendered_depth, w)
    b = 1.0 - masked_pearson(1.0 / (-fused + disparity_const), rendered_depth, w)
    return 0.5 * torch.minimum(a, b)


def loss_reproject_depth(rendered_depth, train_depths, K, R_train, t_train, R_pseudo,
                         t_pseudo, consistency_view_thresh: int = 2, error_range: float = 0.05,
                         disparity_const: float = 200.0) -> torch.Tensor:
    """The multi-view reprojected-depth consistency loss
    (loss_utils.py:321-384): :func:`reproject_fused_depth`, then
    :func:`loss_reproject_from_fused`."""
    fused, w = reproject_fused_depth(train_depths, K, R_train, t_train, R_pseudo, t_pseudo,
                                     consistency_view_thresh, error_range)
    return loss_reproject_from_fused(rendered_depth, fused, w, disparity_const)
