"""Photometric and statistical losses.

Counterpart of ``sdpgs_tpu/losses/basic.py`` (reference utils/loss_utils.py
and utils/image_utils.py). Images are channel-first [C, H, W], as at the
reference's call sites.
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


def _gaussian_window(window_size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
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
    g1 = _gaussian_window(window_size, 1.5, device=img1.device)
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
