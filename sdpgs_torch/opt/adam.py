"""Per-group Adam for the Gaussian parameters.

Counterpart of ``sdpgs_tpu/opt/adam.py`` (reference
scene/gaussian_model.py:217-271): per-group learning rates, the xyz one
log-lerp scheduled and scaled by the scene extent, eps 1e-15, betas
(0.9, 0.999). The moments are plain tensors keyed by field, so
densification can zero single slot rows (``zero_state_rows``), which
``torch.optim.Adam`` cannot; the update is the JAX package's formula
(adam.py:111-124), applied in place under ``torch.no_grad``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
    row equals the whole update's bit for bit."""
    step = state.step + 1
    bc1 = float(1.0 - np.float32(b1) ** np.float32(step))
    bc2 = float(1.0 - np.float32(b2) ** np.float32(step))
    rows = slice(None) if slots is None else slice(*slots)
    for k in TRAINABLE:
        p, grad = getattr(g, k)[rows], grads[k][rows]
        mu, nu = state.mu[k], state.nu[k]
        mu.mul_(b1).add_((1 - b1) * grad)
        nu.mul_(b2).add_((1 - b2) * grad * grad)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p.sub_(lrs[k] * update)
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
