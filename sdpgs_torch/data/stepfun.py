"""Step-function resampling (the mip-NeRF 360 toolkit's used subset).

Counterpart of ``sdpgs_tpu/data/stepfun.py``: the reference vendors the
whole toolkit (utils/stepfun.py) but calls only ``sample_np``, from the
constant-speed ellipse render path (pose_utils.py:237): piecewise-constant
PDF inversion with deterministic or jittered stratified samples.
"""

from __future__ import annotations

import numpy as np


def invert_cdf_np(u: np.ndarray, t: np.ndarray, w_logits: np.ndarray) -> np.ndarray:
    """Invert the CDF defined by knots t [n+1] and interval weights
    softmax(w_logits) [n] at query points u in [0, 1)."""
    w = np.exp(w_logits - w_logits.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    cw = np.concatenate(
        [np.zeros(w.shape[:-1] + (1,)), np.cumsum(w, axis=-1)], axis=-1
    )
    cw[..., -1] = 1.0
    return np.interp(u, cw, t)


def sample_np(
    rand,
    t: np.ndarray,
    w_logits: np.ndarray,
    num_samples: int,
    single_jitter: bool = False,
    deterministic_center: bool = False,
) -> np.ndarray:
    """reference utils/stepfun.py:222-249 (rand path included for parity)."""
    eps = np.finfo(np.float32).eps
    if not rand:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = np.linspace(pad, 1.0 - pad - eps, num_samples)
        else:
            u = np.linspace(0, 1.0 - eps, num_samples)
        u = np.broadcast_to(u, t.shape[:-1] + (num_samples,))
    else:
        u_max = eps + (1 - eps) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - eps
        d = 1 if single_jitter else num_samples
        u = np.linspace(0, 1 - u_max, num_samples) + np.random.rand(
            *t.shape[:-1], d
        ) * max_jitter
    return invert_cdf_np(u, t, w_logits)
