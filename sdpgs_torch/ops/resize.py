"""Separable image resize as two matrix products.

Counterpart of ``sdpgs_tpu/ops/resize.py:33-96``. A fixed-size resize is a
linear map per axis, so the [n_out, n_in] interpolation matrix is built
once in numpy and the resize runs as ``A_y @ img @ A_x^T``. The weights
follow ``torch.nn.functional.interpolate`` exactly (bicubic: Keys kernel,
a = -0.75, 4 taps with clamped indices, no antialias; bilinear: 2 taps,
source coordinate clamped at 0 for half-pixel centres; both
``align_corners`` conventions), so the matrices are the JAX package's.

The JAX package also splits the resize into phases that feed the BiT
stem's stride-2 convolution (``resize2d_stem_phases``/``resize2d_phases``),
a TPU workaround for strided reads; the port computes the same result as
``resize2d`` followed by the strided convolution.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel, torch's a = -0.75 convention."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0, a * (t ** 3 - 5.0 * t ** 2 + 8.0 * t - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, method: str = "bicubic",
                  align_corners: bool = False) -> np.ndarray:
    """[n_out, n_in] f32 interpolation matrix matching
    ``torch.nn.functional.interpolate`` along one axis."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    i = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        src = i * (n_in - 1) / (n_out - 1)
    else:
        src = (i + 0.5) * (n_in / n_out) - 0.5
        if method == "bilinear":
            # area_pixel_compute_source_index clamps at 0 for half-pixel
            # centres; bicubic keeps the raw coordinate and clamps indices
            src = np.maximum(src, 0.0)
    A = np.zeros((n_out, n_in), dtype=np.float64)
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0
    if method == "bicubic":
        taps = [(-1, _cubic_weight(1.0 + frac)), (0, _cubic_weight(frac)),
                (1, _cubic_weight(1.0 - frac)), (2, _cubic_weight(2.0 - frac))]
    elif method == "bilinear":
        taps = [(0, 1.0 - frac), (1, frac)]
    else:
        raise ValueError(f"unknown resize method {method!r}")
    rows = np.arange(n_out)
    for off, w in taps:
        np.add.at(A, (rows, np.clip(x0 + off, 0, n_in - 1)), w)
    return A.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_matrix(n_in: int, n_out: int, method: str, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # cached per device and type: a copy to the card on every call would
    # wait for the host each time
    return torch.from_numpy(resize_matrix(n_in, n_out, method, align_corners)).to(
        device=device, dtype=dtype)


def resize2d(x: torch.Tensor, out_h: int, out_w: int, method: str = "bicubic",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing two axes of ``x`` ([..., H, W]) with torch-parity
    weights, in ``x``'s type; linear, so its gradient is exact."""
    H, W = x.shape[-2], x.shape[-1]
    Ay = _device_matrix(H, out_h, method, align_corners, x.device, x.dtype)
    Ax = _device_matrix(W, out_w, method, align_corners, x.device, x.dtype)
    out = torch.matmul(torch.matmul(Ay, x.reshape(-1, H, W)), Ax.T)
    return out.reshape(x.shape[:-2] + (out_h, out_w))
