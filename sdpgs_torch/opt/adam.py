"""Per-group Adam for the Gaussian parameters.

Counterpart of ``sdpgs_tpu/opt/adam.py`` (reference
scene/gaussian_model.py:217-271): per-group learning rates, the xyz one
log-lerp scheduled and scaled by the scene extent, eps 1e-15, betas
(0.9, 0.999). The moments are plain tensors keyed by field, so
densification can zero single slot rows (``zero_state_rows``), which
``torch.optim.Adam`` cannot; the update is the JAX package's formula
(adam.py:111-124), applied in place under ``torch.no_grad``.

On CUDA tensors one launch of ``fused_adam_kernel`` (``csrc/adam.cu``)
updates all seven groups, reading each gradient in place by its strides
and rounding every operation as the plain version's op chain does on the
card, so the two agree bit for bit; on CPU tensors the plain version runs.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sdpgs_torch import _kernels

TRAINABLE = (
    "xyz",
    "features_dc",
    "features_rest",
    "scaling",
    "rotation",
    "opacity",
    "language_feature",
)


def trainable_params(g) -> Dict[str, torch.Tensor]:
    return {k: getattr(g, k) for k in TRAINABLE}


@dataclass
class GaussianAdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int


def adam_init(g) -> GaussianAdamState:
    params = trainable_params(g)
    return GaussianAdamState(
        mu={k: torch.zeros_like(v, requires_grad=False) for k, v in params.items()},
        nu={k: torch.zeros_like(v, requires_grad=False) for k, v in params.items()},
        step=0,
    )


def expon_lr(step: int, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear decay with an optional sine-eased delay
    (reference utils/general_utils.py:39-72), in f32 as the JAX package
    computes it."""
    f32 = np.float32
    lr_init, lr_final = f32(lr_init), f32(lr_final)
    if step < 0:
        return 0.0
    t = np.clip(f32(step) / f32(max_steps), f32(0.0), f32(1.0))
    if lr_init == 0.0 and lr_final == 0.0:
        log_lerp = f32(0.0)
    else:
        safe_init = max(lr_init, f32(1e-30))
        safe_final = max(lr_final, f32(1e-30))
        log_lerp = np.exp(np.log(safe_init) * (f32(1.0) - t) + np.log(safe_final) * t)
    if lr_delay_steps > 0:
        frac = np.clip(f32(step) / f32(lr_delay_steps), f32(0.0), f32(1.0))
        delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(f32(0.5 * math.pi) * frac)
    else:
        delay = f32(1.0)
    return float(f32(delay * log_lerp))


def learning_rates(opt_cfg, step: int, spatial_lr_scale: float) -> Dict[str, float]:
    """Per-group learning rates at a step (reference gaussian_model.py:
    228-238, 277-284: f_rest = feature_lr / 20, xyz scheduled)."""
    scale = float(np.float32(spatial_lr_scale))
    xyz_lr = expon_lr(step, opt_cfg.position_lr_init * scale,
                      opt_cfg.position_lr_final * scale,
                      lr_delay_mult=opt_cfg.position_lr_delay_mult,
                      max_steps=opt_cfg.position_lr_max_steps)
    f = lambda v: float(np.float32(v))  # noqa: E731
    return {
        "xyz": xyz_lr,
        "features_dc": f(opt_cfg.feature_lr),
        "features_rest": f(opt_cfg.feature_lr / 20.0),
        "scaling": f(opt_cfg.scaling_lr),
        "rotation": f(opt_cfg.rotation_lr),
        "opacity": f(opt_cfg.opacity_lr),
        "language_feature": f(opt_cfg.language_feature_lr),
    }


class AdamGroupC(ctypes.Structure):
    """One group as ``fused_adam_kernel`` reads it (``SdpgsAdamGroup`` of
    ``csrc/adam.cu``, field for field): ``rows`` rows of ``width`` floats,
    the parameter's from ``p`` and the moments' from ``m`` and ``v``,
    dense; the gradient's float (row, a, b) of a row seen as
    [width // inner, inner] at ``g + 4 * (row * g_row + a * g_mid + b *
    g_col)``."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("m", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("g_row", ctypes.c_longlong),
                ("g_mid", ctypes.c_longlong), ("g_col", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("width", ctypes.c_int), ("inner", ctypes.c_int),
                ("lr", ctypes.c_float)]


def _check_f32(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def adam_groups(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                lrs: Dict[str, float], slots: Optional[Tuple[int, int]] = None):
    """The kernel's table: one ``AdamGroupC`` per field of ``TRAINABLE``,
    for the whole fields ``params`` and ``grads`` at rows ``slots`` (all by
    default) and the moments of those rows; reads shapes, strides and
    addresses only. A gradient whose middle and last axes lie as one row
    collapses to ``inner == width``."""
    groups = []
    for k in TRAINABLE:
        p, g = params[k], grads[k]
        lo, hi = (0, p.shape[0]) if slots is None else slots
        if not 0 <= lo <= hi <= p.shape[0] or not 2 <= p.dim() <= 3:
            raise ValueError(f"{k}: rows {lo}:{hi} of a {tuple(p.shape)} field")
        width = math.prod(p.shape[1:])
        _check_f32(p, k, p.shape)
        _check_f32(g, f"{k} gradient", p.shape)
        for name, t in ((f"{k} mu", mu[k]), (f"{k} nu", nu[k])):
            _check_f32(t, name, (hi - lo,) + tuple(p.shape[1:]))
            if not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous tensor")
        if not p.is_contiguous():
            raise ValueError(f"{k}: expected a contiguous parameter")
        if p.dim() == 2:
            inner, g_mid, g_col = width, 0, g.stride(1)
        elif p.shape[1] == 1 or g.stride(1) == p.shape[2] * g.stride(2):
            inner, g_mid, g_col = width, 0, g.stride(2)
        else:
            inner, g_mid, g_col = p.shape[2], g.stride(1), g.stride(2)
        groups.append(AdamGroupC(p.data_ptr() + 4 * lo * width,
                                 g.data_ptr() + 4 * lo * g.stride(0), mu[k].data_ptr(),
                                 nu[k].data_ptr(), g.stride(0), g_mid, g_col, hi - lo, width,
                                 inner, lrs[k]))
    return (AdamGroupC * len(groups))(*groups)


def bias_corrections(step: int, b1: float, b2: float) -> Tuple[float, float]:
    """1 - b1^step and 1 - b2^step, in float32 as the JAX package takes them."""
    return (float(1.0 - np.float32(b1) ** np.float32(step)),
            float(1.0 - np.float32(b2) ** np.float32(step)))


def adam_scalars(step: int, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> tuple:
    """The step's float32 constants as the op chain's kernels use them on
    the card: b1, 1 - b1, b2, 1 - b2 (Python scalars, each cast to float),
    1 / bc1 and 1 / bc2 (a CPU scalar divisor becomes its float
    reciprocal) and eps."""
    f32 = np.float32
    bc1, bc2 = bias_corrections(step, b1, b2)
    return (f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(1) / f32(bc1), f32(1) / f32(bc2),
            f32(eps))


def fused_adam(params, grads, mu, nu, lrs, step: int, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-15, slots: Optional[Tuple[int, int]] = None) -> None:
    """One launch of ``fused_adam_kernel``: every group of ``params``
    (rows ``slots``) and the moments ``mu``, ``nu`` updated in place from
    ``grads`` at Adam step ``step`` (counted from 1)."""
    dev = params[TRAINABLE[0]].device
    if any(t.device != dev for k in TRAINABLE for t in (params[k], grads[k], mu[k], nu[k])):
        raise ValueError(f"Adam's tensors do not all live on {dev}")
    table = adam_groups(params, grads, mu, nu, lrs, slots)
    _kernels.launch("adam", "sdpgs_fused_adam", ctypes.addressof(table), len(table),
                    *adam_scalars(step, b1, b2, eps), _kernels.stream(dev))
    torch.autograd.graph.increment_version([params[k] for k in TRAINABLE]
                                           + [mu[k] for k in TRAINABLE]
                                           + [nu[k] for k in TRAINABLE])


def adam_update_plain(params, grads, mu, nu, lrs, step: int, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-15) -> None:
    """Plain PyTorch version of ``fused_adam``, on rows already cut to the
    moments': the op chain, 14 elementwise operations a group."""
    _kernels.plain_call("adam")
    bc1, bc2 = bias_corrections(step, b1, b2)
    for k in TRAINABLE:
        p, grad = params[k], grads[k]
        mu[k].mul_(b1).add_((1 - b1) * grad)
        nu[k].mul_(b2).add_((1 - b2) * grad * grad)
        update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
        p.sub_(lrs[k] * update)


@torch.no_grad()
def adam_update(g, grads: Dict[str, torch.Tensor], state: GaussianAdamState,
                lrs: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15, slots: Optional[Tuple[int, int]] = None
                ) -> GaussianAdamState:
    """One Adam step: updates ``g``'s parameters and the moments in place
    and returns the state with its step advanced. With ``slots=(lo, hi)``
    (ZeRO-1 on the mesh's ``gauss`` axis) the moments hold those slots'
    rows only, and only those rows of the parameters are updated, from the
    same rows of the whole gradients; the update is elementwise, so each
    row equals the whole update's bit for bit. On CUDA tensors it is one
    launch of the fused kernel (or raises), on CPU tensors the plain
    version."""
    step = state.step + 1
    params = trainable_params(g)
    if params[TRAINABLE[0]].is_cuda:
        fused_adam(params, grads, state.mu, state.nu, lrs, step, b1, b2, eps, slots)
    else:
        rows = slice(None) if slots is None else slice(*slots)
        adam_update_plain({k: v[rows] for k, v in params.items()},
                          {k: grads[k][rows] for k in TRAINABLE}, state.mu, state.nu, lrs,
                          step, b1, b2, eps)
    return GaussianAdamState(mu=state.mu, nu=state.nu, step=step)


@torch.no_grad()
def zero_state_rows(state: GaussianAdamState, rows: torch.Tensor,
                    keys: tuple = TRAINABLE) -> GaussianAdamState:
    """Zero the moment rows where ``rows`` (float or bool [P]) is set, in
    place: the replacement for the reference's optimizer-state surgery."""
    keep = 1.0 - rows.to(torch.float32)
    for d in (state.mu, state.nu):
        for k in keys:
            d[k].mul_(keep.reshape((-1,) + (1,) * (d[k].ndim - 1)))
    return state
