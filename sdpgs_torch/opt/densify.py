"""Densification statistics.

Counterpart of ``sdpgs_tpu/opt/densify.py:38-99``: the per-Gaussian
accumulators the reference's adaptive density control reads
(gaussian_model.py:610-612). Clone, split, prune and the opacity reset
come with the Trainer slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DensifyStats:
    xyz_gradient_accum: torch.Tensor  # [P]
    denom: torch.Tensor               # [P]
    max_radii2d: torch.Tensor         # [P]


def init_stats(capacity: int, device=None) -> DensifyStats:
    return DensifyStats(*(torch.zeros(capacity, dtype=torch.float32, device=device)
                          for _ in range(3)))


def add_densification_stats(stats: DensifyStats, viewspace_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor,
                            width: int, height: int) -> DensifyStats:
    """One view: [P, 2] pixel-space screen gradients, [P] visibility and
    radii. The reference accumulates NDC-scaled gradients (backward.cu:
    460-461 scales by W/2, H/2), so the pixel gradients are rescaled to keep
    densify_grad_threshold's calibration."""
    return add_densification_stats_batched(stats, viewspace_grad[None], visibility[None],
                                           radii[None], width, height)


def add_densification_stats_batched(stats: DensifyStats, viewspace_grads: torch.Tensor,
                                    visibility: torch.Tensor, radii: torch.Tensor,
                                    width: int, height: int) -> DensifyStats:
    """A batch of views at once: [V, P, 2] gradients, [V, P] visibility and
    radii; the same accumulation as V calls of add_densification_stats."""
    gx = viewspace_grads[..., 0] * (0.5 * width)
    gy = viewspace_grads[..., 1] * (0.5 * height)
    norm = torch.sqrt(gx * gx + gy * gy)
    vis = visibility.to(torch.float32)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + torch.sum(norm * vis, dim=0),
        denom=stats.denom + torch.sum(vis, dim=0),
        max_radii2d=torch.maximum(stats.max_radii2d, torch.amax(radii * vis, dim=0)),
    )
