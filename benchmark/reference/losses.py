"""The losses of the train step and the reprojection z-buffer, in plain
PyTorch.

Copied from ``sdpgs_torch/losses/basic.py``, ``feature.py`` and
``depth.py`` and from the plain version of kernel K6 in
``sdpgs_torch/ops/warp.py`` (the scatter-min z-buffer).
"""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """reference loss_utils.py:106."""
    return torch.mean(torch.abs(pred - gt))


def l1_loss_mask(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    """reference loss_utils.py:109-113."""
    if mask is None:
        return l1_loss(pred, gt)
    return torch.sum(torch.abs((pred - gt) * mask)) / torch.sum(mask)


def pearson_corrcoef(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pearson correlation of two flattened tensors. The variance product
    is clamped inside the sqrt (whose gradient at 0 is infinite), so a
    constant input gives a zero gradient, not NaN."""
    x = x.reshape(-1)
    y = y.reshape(-1)
    xm = x - torch.mean(x)
    ym = y - torch.mean(y)
    denom = torch.sqrt(torch.clamp_min(torch.sum(xm * xm) * torch.sum(ym * ym), eps * eps))
    return torch.sum(xm * ym) / denom


def _gaussian_window(window_size: int, sigma: float, device=None,
                     dtype=torch.float32) -> torch.Tensor:
    x = torch.arange(window_size, dtype=dtype, device=device) - window_size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _blur_matrix(n: int, kernel1d: torch.Tensor) -> torch.Tensor:
    """Banded Toeplitz matrix applying a zero-padded 'same' 1-D convolution:
    out = M @ x with M[i, j] = kernel[j - i + pad]."""
    k = kernel1d.shape[0]
    pad = k // 2
    idx = torch.arange(n, device=kernel1d.device)
    off = idx[None, :] - idx[:, None] + pad
    valid = (off >= 0) & (off < k)
    return torch.where(valid, kernel1d[torch.clamp(off, 0, k - 1)],
                       torch.zeros((), dtype=kernel1d.dtype, device=kernel1d.device))


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """[C, H, W] per-channel 2-D convolution with a separable window, zero
    'same' padding, as two banded-Toeplitz matmuls in f32 (TF32 is off)."""
    _, H, W = img.shape
    col = torch.sum(window, dim=1)
    row = torch.sum(window, dim=0) / torch.clamp_min(torch.sum(window), 1e-12)
    Tc = _blur_matrix(H, col)
    Tr = _blur_matrix(W, row)
    return torch.matmul(Tc, torch.matmul(img, Tr.T))


def ssim(img1: torch.Tensor, img2: torch.Tensor, mask=None,
         window_size: int = 11) -> torch.Tensor:
    """Windowed SSIM with the 11x11 sigma-1.5 Gaussian window
    (reference loss_utils.py:119-163). Images [C, H, W] in [0, 1]."""
    if mask is not None:
        img1 = img1 * mask + (1.0 - mask)
        img2 = img2 * mask + (1.0 - mask)
    g1 = _gaussian_window(window_size, 1.5, device=img1.device, dtype=img1.dtype)
    window = torch.outer(g1, g1)
    C = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    blurred = _depthwise_conv(stacked, window)
    mu1, mu2, m11, m22, m12 = (blurred[i * C:(i + 1) * C] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def psnr(img1: torch.Tensor, img2: torch.Tensor, mask=None) -> torch.Tensor:
    """reference utils/image_utils.py:14-22 (per-image mean over pixels)."""
    if mask is None:
        mse = torch.mean((img1 - img2) ** 2)
    else:
        m = torch.broadcast_to(mask, img1.shape)
        mse = torch.sum(((img1 - img2) * m) ** 2) / torch.clamp_min(torch.sum(m), 1.0)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def _smooth_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalize with a smooth norm: the gradient is 0 (not NaN) at
    x == 0, as at every background pixel of a rendered feature image."""
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def _cosine_to_prototypes(feat: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """[N, C] x [S, C] -> [N, S] cosine similarity."""
    return _smooth_normalize(feat) @ _smooth_normalize(protos).T


def penalty_loss(pred: torch.Tensor, penalty: str = "l2") -> torch.Tensor:
    """Spatial smoothness of an [H, W, C] map: mean squared (or absolute)
    first differences along H and W, each divided by ndims = 2
    (reference loss_utils.py:212-248)."""
    dh = pred[1:, :, :] - pred[:-1, :, :]
    dw = pred[:, 1:, :] - pred[:, :-1, :]
    if penalty == "l1":
        return (torch.mean(torch.abs(dh)) + torch.mean(torch.abs(dw))) / 2.0
    return (torch.mean(dh ** 2) + torch.mean(dw ** 2)) / 2.0


def loss_feature_metric(language_feature: torch.Tensor, gt_language_feature: torch.Tensor,
                        prototypes: torch.Tensor, seg_map: torch.Tensor,
                        known_fce: float = 0.01, known_fl1: float = 1.0,
                        known_fsm: float = 1e-6, label_smoothing: float = 1e-3):
    """Label-smoothed cross-entropy of softmax(cosine similarity to the
    [S, 3] prototypes) + L1 + spatial smoothness (reference
    loss_utils.py:251-307) on [3, H, W] feature images and an [H, W] int
    segment map. Returns (loss_feature, loss_smooth)."""
    S = prototypes.shape[0]
    pred = language_feature.permute(1, 2, 0).reshape(-1, 3)
    gt = gt_language_feature.permute(1, 2, 0).reshape(-1, 3)
    p_k = torch.softmax(_cosine_to_prototypes(pred, prototypes), dim=-1)
    seg = torch.clamp(seg_map.reshape(-1).long(), 0, S - 1)
    one_hot = torch.nn.functional.one_hot(seg, S).to(pred.dtype)
    q_k = (1.0 - label_smoothing) * one_hot + label_smoothing / S
    ce = -torch.sum(q_k * torch.log(p_k + 1e-8), dim=1).mean()
    loss_feature = known_fce * ce + known_fl1 * l1_loss(pred, gt)
    loss_smooth = known_fsm * penalty_loss(language_feature.permute(1, 2, 0))
    return loss_feature, loss_smooth


def segment_cluster_assign(feature_img: torch.Tensor, prototypes: torch.Tensor,
                           window: int = 7) -> torch.Tensor:
    """Each pixel's segment: the one whose softmax probability (of the
    cosine to the [S, 3] prototypes) is largest over a window x window
    neighbourhood, the first on a tie (reference train.py:161-171's
    ``max_pool3d`` trick, as a spatial max-pool per segment and an argmax
    over segments). [3, H, W] -> [H, W] int32. The max-pool pads with
    -inf, as ``reduce_window``'s init value does in JAX."""
    _, H, W = feature_img.shape
    feat = feature_img.permute(1, 2, 0).reshape(-1, 3)
    p_k = torch.softmax(_cosine_to_prototypes(feat, prototypes), dim=-1)      # [N, S]
    p_img = p_k.T.reshape(1, -1, H, W)
    pooled = torch.nn.functional.max_pool2d(p_img, window, stride=1, padding=window // 2)
    return torch.argmax(pooled[0], dim=0).to(torch.int32)


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


def loss_reproject_from_fused(rendered_depth: torch.Tensor, fused: torch.Tensor,
                              w: torch.Tensor, disparity_const: float = 200.0) -> torch.Tensor:
    """Pearson (with the disparity fallback) of the rendered pseudo depth
    against the fused reprojection (loss_utils.py:362-384)."""
    a = 1.0 - masked_pearson(fused, rendered_depth, w)
    b = 1.0 - masked_pearson(1.0 / (-fused + disparity_const), rendered_depth, w)
    return 0.5 * torch.minimum(a, b)


def pair_rows(K, R_train, t_train, R_pseudo, t_pseudo) -> torch.Tensor:
    """[B * V, 12] f32: per pair (b, v), row-major b * V + v, the rows
    (proj_r0, proj_r1, proj_r2, c_r) for r = 0, 1, 2 of
    proj = (K R_b)(K R_v)^-1 and c = K (t_b - R_b R_v^T t_v)
    (warp_pallas.py:152-153)."""
    Rb, tb = R_pseudo[:, None], t_pseudo[:, None]            # [B, 1, ...]
    Rv, tv = R_train[None], t_train[None]                    # [1, V, ...]
    # inv_ex: no device sync to check for a singular matrix
    proj = (K @ Rb) @ torch.linalg.inv_ex(K @ Rv)[0]          # [B, V, 3, 3]
    c = K @ (tb - (Rb @ Rv.transpose(-1, -2) @ tv[..., None])[..., 0])[..., None]
    rows = torch.cat([proj, c], dim=-1)                       # [B, V, 3, 4]
    return rows.reshape(-1, 12).to(torch.float32).contiguous()


def project_rows(depths: torch.Tensor, pc: torch.Tensor):
    """The shared projection math (JAX ``project_rows``): for every pair's
    source pixels, flat (u, v, z, valid) of shape [n, H * W], u and v as
    rounded floats. Each pair p reads ``depths[p % V]``."""
    V, H, W = depths.shape
    n = pc.shape[0]
    dev = depths.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    x, y = xs.reshape(1, -1), ys.reshape(1, -1)
    d = depths.reshape(V, -1)[torch.arange(n, device=dev) % V]   # [n, HW]
    m = [pc[:, j:j + 1] for j in range(12)]

    def row(r):   # (P_r0 x + P_r1 y + P_r2) d + c_r, one rounding per op
        return (m[4 * r] * x + m[4 * r + 1] * y + m[4 * r + 2]) * d + m[4 * r + 3]

    X0, X1, z = row(0), row(1), row(2)
    u = torch.round(X0 / z)
    v = torch.round(X1 / z)
    valid = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0) & (d > 0)
    return u, v, z, valid


def scatter_rows(u, v, z, valid, H: int, W: int):
    """The (index, value) rows of the scatter-min over all pairs: index
    ``p * H * W + v * W + u``, or ``n * H * W`` (a dropped slot) for an
    invalid row."""
    n = u.shape[0]
    base = torch.arange(n, device=u.device, dtype=torch.int64)[:, None] * (H * W)
    ui = torch.where(valid, u, 0).to(torch.int64)
    vi = torch.where(valid, v, 0).to(torch.int64)
    idx = torch.where(valid, base + vi * W + ui, n * H * W)
    return idx.reshape(-1), torch.where(valid, z, torch.inf).reshape(-1)


@torch.no_grad()
def reproject_fused_depth_batch(train_depths, K, R_train, t_train, R_pseudo, t_pseudo,
                                consistency_view_thresh: int = 2, error_range: float = 0.05):
    """Warp every train view's depth [V, H, W] into each of B pseudo views
    (scatter-min z-buffer, 0 = hole), fuse, and keep the pixels where two
    views agree within 0.05. Returns (fused [B, H, W], weight [B, H, W])."""
    V, H, W = train_depths.shape
    B = R_pseudo.shape[0]
    pc = pair_rows(K, R_train, t_train, R_pseudo, t_pseudo)
    n = pc.shape[0]
    idx, zv = scatter_rows(*project_rows(train_depths.contiguous(), pc), H, W)
    buf = torch.full((n * H * W + 1,), torch.inf, dtype=torch.float32, device=train_depths.device)
    buf.scatter_reduce_(0, idx, zv, reduce="amin")
    zbuf = buf[:-1].reshape(n, H, W)
    warped = torch.where(torch.isinf(zbuf), 0.0, zbuf).reshape(B, V, H, W)
    return _fuse_warped(warped, consistency_view_thresh, error_range)
