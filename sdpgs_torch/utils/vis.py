"""Visualization helpers (reference utils/visualization_utils.py and
vis_depth, general_utils.py:145-173). Host numpy, a copy of
``sdpgs_tpu/utils/vis.py``."""

from __future__ import annotations

import numpy as np

# Piecewise-polynomial approximation of the Turbo colormap (Google's
# published fit constants are public domain).
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def turbo_colormap(t: np.ndarray) -> np.ndarray:
    """t in [0, 1] -> [..., 3] RGB."""
    t = np.clip(t, 0.0, 1.0)
    tp = np.stack([np.ones_like(t), t, t**2, t**3, t**4, t**5], axis=-1)
    rgb = np.stack([tp @ _TURBO_R, tp @ _TURBO_G, tp @ _TURBO_B], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def weighted_percentile(x: np.ndarray, w: np.ndarray, ps) -> np.ndarray:
    """reference visualization_utils.py:7-14."""
    x = x.reshape(-1)
    w = w.reshape(-1)
    order = np.argsort(x)
    x, w = x[order], w[order]
    acc = np.cumsum(w)
    return np.interp(np.asarray(ps) / 100.0 * acc[-1], acc, x)


def vis_depth(depth: np.ndarray, mask: np.ndarray | None = None,
              lo_p: float = 0.5, hi_p: float = 99.5) -> np.ndarray:
    """Depth -> turbo-colored image with robust percentile normalization
    (reference vis_depth / visualize_cmap)."""
    w = (mask if mask is not None else (depth > 0)).astype(np.float64)
    if w.sum() == 0:
        w = np.ones_like(w)
    lo, hi = weighted_percentile(depth, w, [lo_p, hi_p])
    t = (depth - lo) / max(hi - lo, 1e-9)
    return turbo_colormap(t)


def depth_to_image(depth: np.ndarray) -> np.ndarray:
    """uint8 turbo visualization."""
    return (vis_depth(depth) * 255).astype(np.uint8)
