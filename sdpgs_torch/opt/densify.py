"""Adaptive density control on static-capacity masked arrays.

Counterpart of ``sdpgs_tpu/opt/densify.py``: the per-Gaussian
accumulators the reference's adaptive density control reads
(gaussian_model.py:610-612), and clone, split, proximity bridging, prune
and the opacity reset (gaussian_model.py:351-355, 400-612) as mask flips
and slot reuse: children are written into dead slots, allocated by a
stable argsort of the alive mask, so no shape changes.

The JAX package returns new arrays; here ``densify_and_prune`` and
``reset_opacity`` write into the ``Gaussians``' own parameter and buffer
tensors and the Adam moments in place (under ``no_grad``), so the tensors
a train step differentiates and ``adam_update`` updates stay the same
objects. Every count stays on the device: no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from sdpgs_torch.core.transforms import normalize_quat, quat_to_rotmat
from sdpgs_torch.opt.adam import zero_state_rows

# log(0.8 * 2.0) in f32, as JAX computes it (split children's scale, :175)
_LOG_1_6 = torch.log(torch.tensor(0.8 * 2.0, dtype=torch.float32))


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


def densification_increments(viewspace_grads: torch.Tensor, visibility: torch.Tensor,
                             radii: torch.Tensor, width: int, height: int) -> DensifyStats:
    """What a batch of views ([V, P, 2] gradients, [V, P] visibility and
    radii) adds to the statistics: the sums over the views of the gradient
    norms and of the visibility, and the views' largest radius. On a mesh
    the sums are summed and the radius maxed over the ``data`` axis; the
    gradients must be whole (summed over the tiles) before the norm."""
    gx = viewspace_grads[..., 0] * (0.5 * width)
    gy = viewspace_grads[..., 1] * (0.5 * height)
    norm = torch.sqrt(gx * gx + gy * gy)
    vis = visibility.to(torch.float32)
    return DensifyStats(xyz_gradient_accum=torch.sum(norm * vis, dim=0),
                        denom=torch.sum(vis, dim=0),
                        max_radii2d=torch.amax(radii * vis, dim=0))


def add_densification_stats_batched(stats: DensifyStats, viewspace_grads: torch.Tensor,
                                    visibility: torch.Tensor, radii: torch.Tensor,
                                    width: int, height: int) -> DensifyStats:
    """A batch of views at once: [V, P, 2] gradients, [V, P] visibility and
    radii; the same accumulation as V calls of add_densification_stats."""
    return apply_increments(stats, densification_increments(viewspace_grads, visibility,
                                                            radii, width, height))


def apply_increments(stats: DensifyStats, inc: DensifyStats) -> DensifyStats:
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + inc.xyz_gradient_accum,
        denom=stats.denom + inc.denom,
        max_radii2d=torch.maximum(stats.max_radii2d, inc.max_radii2d),
    )


class DensifyInfo(NamedTuple):
    """0-d int32 tensors on the Gaussians' device."""

    spawned: torch.Tensor   # children actually written
    dropped: torch.Tensor   # children lost to capacity
    pruned: torch.Tensor    # Gaussians killed this round (split sources included)
    num_alive: torch.Tensor


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[P] mask shaped to broadcast over ``like``'s trailing dims."""
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


@torch.no_grad()
def densify_and_prune(g, opt_state, stats: DensifyStats, noise: torch.Tensor, *,
                      grad_threshold: float, min_opacity: float, extent: float,
                      percent_dense: float, run_proximity: bool,
                      knn_dist: torch.Tensor | None = None,
                      knn_idx: torch.Tensor | None = None,
                      max_screen_size: float | None = None):
    """One densify-and-prune event (JAX densify.py:109-233).

    ``noise`` [P, 3] is a standard normal draw (JAX draws it inside from
    its key; here the caller draws it from ``TrainState.generator``), the
    split children's offsets before scaling. ``knn_dist`` [P] (mean squared
    distance to the 3 nearest neighbours) and ``knn_idx`` [P, 3] feed the
    proximity rule. Updates ``g`` and ``opt_state`` in place and returns
    (g, opt_state, fresh statistics, DensifyInfo)."""
    P = g.capacity
    dev = g.device
    alive = g.alive > 0.0
    grads = torch.where(stats.denom > 0, stats.xyz_gradient_accum / stats.denom, 0.0)
    grads = torch.nan_to_num(grads)

    max_scale = torch.amax(torch.exp(g.scaling), dim=-1)
    hit = alive & (grads >= grad_threshold)
    clone_m = hit & (max_scale <= percent_dense * extent)
    split_m = hit & (max_scale > percent_dense * extent)
    if run_proximity and knn_dist is not None:
        prox_m = alive & (knn_dist > 5.0 * extent) & (max_scale > extent)
    else:
        prox_m = torch.zeros_like(alive)
        knn_idx = torch.zeros((P, 3), dtype=torch.int64, device=dev)

    c = clone_m.to(torch.int64)
    s = split_m.to(torch.int64)
    counts = c + 2 * s + 3 * prox_m.to(torch.int64)
    cum = torch.cumsum(counts, 0)
    starts = cum - counts
    total_new = cum[-1]

    # free-slot ranks: a stable sort puts the dead slots (alive = 0) first
    order = torch.argsort(alive.to(torch.int32), stable=True)
    num_free = P - alive.sum()
    spawned = torch.minimum(total_new, num_free)
    dropped = total_new - spawned

    r = torch.arange(P, dtype=torch.int64, device=dev)
    active = r < spawned
    src = torch.clamp(torch.searchsorted(cum, r, right=True), 0, P - 1)
    off = r - starts[src]
    c_src, s_src = c[src], s[src]
    # a child is a clone when it is neither a split child nor a proximity one
    split_off = off - c_src
    is_split = active & (split_off >= 0) & (split_off < 2 * s_src)
    prox_off = off - c_src - 2 * s_src
    is_prox = active & (prox_off >= 0)
    neighbor = knn_idx.to(torch.int64)[src, torch.clamp(prox_off, 0, 2)]

    # --- child parameters, by slot rank r --------------------------------
    offset = noise * torch.exp(g.scaling[src])
    R = quat_to_rotmat(normalize_quat(g.rotation[src]))                  # [P, 3, 3]
    split_xyz = g.xyz[src] + torch.einsum("pij,pj->pi", R, offset)
    split_scaling = g.scaling[src] - _LOG_1_6.to(dev)
    prox_xyz = (g.xyz[src] + g.xyz[neighbor]) * 0.5
    identity_quat = torch.zeros((P, 4), dtype=torch.float32, device=dev)
    identity_quat[:, 0] = 1.0

    def pick(prox, split, clone):
        out = clone if split is None else torch.where(_rows(is_split, clone), split, clone)
        return torch.where(_rows(is_prox, out), prox, out)

    child = {
        "xyz": pick(prox_xyz, split_xyz, g.xyz[src]),
        "features_dc": pick(0.0, None, g.features_dc[src]),
        "features_rest": pick(0.0, None, g.features_rest[src]),
        "scaling": pick(g.scaling[neighbor], split_scaling, g.scaling[src]),
        "rotation": pick(identity_quat, None, g.rotation[src]),
        "opacity": pick(g.opacity[neighbor], None, g.opacity[src]),
        "language_feature": pick(g.language_feature[neighbor], None,
                                 g.language_feature[src]),
        "confidence": torch.ones((P, 1), dtype=torch.float32, device=dev),
    }

    # --- write the children into the free slots, in place ----------------
    for name, val in child.items():
        cur = getattr(g, name)
        cur[order] = torch.where(_rows(active, cur), val, cur[order])

    spawn_row = torch.zeros((P,), dtype=torch.bool, device=dev)
    spawn_row[order] = active
    # split sources die (gaussian_model.py:563-564)
    alive_new = (alive | spawn_row) & ~split_m

    # --- opacity prune on the post-spawn population -----------------------
    prune = alive_new & (torch.sigmoid(g.opacity[:, 0]) < min_opacity)
    if max_screen_size is not None:
        big_vs = stats.max_radii2d > max_screen_size
        big_ws = max_scale > 0.1 * extent
        prune = prune | (alive_new & (big_vs | big_ws))
    alive_final = alive_new & ~prune
    g.alive.copy_(alive_final.to(torch.float32))

    # new and dead slots get zeroed Adam moments (reference cat_tensors zero-pads)
    zero_state_rows(opt_state, spawn_row | ~alive_final)

    i32 = lambda v: v.to(torch.int32)  # noqa: E731
    info = DensifyInfo(spawned=i32(spawned), dropped=i32(dropped),
                       pruned=i32((alive_new & prune).sum() + split_m.sum()),
                       num_alive=i32(alive_final.sum()))
    return g, opt_state, init_stats(P, device=dev), info


@torch.no_grad()
def reset_opacity(g, opt_state, ceiling: float = 0.01):
    """Clamp the activated opacity to at most ``ceiling`` and zero the
    opacity moments (reference gaussian_model.py:351-355 and
    replace_tensor_to_optimizer), in place; ``log(a / (1 - a))`` in f32 as
    JAX computes it (``torch.logit`` would clamp with an eps)."""
    act = torch.clamp_max(torch.sigmoid(g.opacity), ceiling)
    g.opacity.copy_(torch.log(act / (1.0 - act)))
    # every row of the moments this rank holds (all of them, or its slots)
    rows = opt_state.mu["opacity"].shape[0]
    zero_state_rows(opt_state, torch.ones((rows,), dtype=torch.float32, device=g.device),
                    keys=("opacity",))
    return g, opt_state
