"""The reference densify-and-prune event, without the proximity rule (the
cells densify after iteration 2,000, where the schedule has dropped it).

The semantics of ``sdpgs_torch/opt/densify.py:densify_and_prune`` and of
the reference's ``gaussian_model.py`` it follows, written out plainly:
the alive Gaussians whose mean screen gradient reaches the threshold are
cloned (small ones: one child, a copy) or split (large ones: two children
displaced by the noise rows of their ranks along the source's axes, their
scales over 1.6; the source dies); the children take the dead slots in
index order, as many as there are; then every Gaussian whose opacity is
under the floor is pruned; the Adam moments of new and dead rows are
zeroed and the statistics start again.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.raster import FIELDS

LOG_1_6 = float(torch.log(torch.tensor(1.6, dtype=torch.float32)))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] quaternions (w, x, y, z), normalised here -> [N, 3, 3]."""
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


@torch.no_grad()
def densify_and_prune(state: dict, noise: torch.Tensor, *, grad_threshold: float,
                      min_opacity: float, extent: float, percent_dense: float) -> dict:
    """``state``: the fields of ``FIELDS`` and ``confidence`` [P, ...],
    ``alive`` [P] (0 or 1), ``mu`` and ``nu`` (field -> [P, ...]),
    ``accum``, ``denom`` [P]; ``noise`` [P, 3]. Returns the state after the
    event, in new tensors."""
    live = state["alive"] > 0
    P = live.shape[0]
    grads = torch.nan_to_num(torch.where(state["denom"] > 0,
                                         state["accum"] / state["denom"], 0.0))
    max_scale = torch.exp(state["scaling"]).amax(dim=-1)
    hit = live & (grads >= grad_threshold)
    small = max_scale <= percent_dense * extent
    clone = hit & small
    split = hit & (max_scale > percent_dense * extent)

    # the children in the order of their sources: one for a clone, two for
    # a split; child n takes the n-th dead slot and the n-th noise row
    per_source = clone.long() + 2 * split.long()
    src = torch.repeat_interleave(torch.arange(P, device=live.device), per_source)
    free = torch.nonzero(~live).flatten()
    n = min(src.numel(), free.numel())
    src, slot = src[:n], free[:n]
    is_split = split[src]

    out = {k: state[k].clone() for k in FIELDS + ("confidence",)}
    for k in FIELDS:
        out[k][slot] = state[k][src]
    out["confidence"][slot] = 1.0
    s_src, s_slot = src[is_split], slot[is_split]
    offset = noise[:n][is_split] * torch.exp(state["scaling"][s_src])
    moved = torch.matmul(rotation(state["rotation"][s_src]), offset[:, :, None])[:, :, 0]
    out["xyz"][s_slot] = state["xyz"][s_src] + moved
    out["scaling"][s_slot] = state["scaling"][s_src] - LOG_1_6

    spawned = torch.zeros(P, dtype=torch.bool, device=live.device)
    spawned[slot] = True
    alive = (live | spawned) & ~split
    alive = alive & ~(torch.sigmoid(out["opacity"][:, 0]) < min_opacity)
    out["alive"] = alive.to(torch.float32)
    keep = (~(spawned | ~alive)).to(torch.float32)
    for m in ("mu", "nu"):
        out[m] = {k: v * keep.reshape((-1,) + (1,) * (v.ndim - 1)) for k, v in state[m].items()}
    out["accum"] = torch.zeros_like(state["accum"])
    out["denom"] = torch.zeros_like(state["denom"])
    return out


def readings(prog: dict, ref: dict) -> dict:
    """``densify_slots``: rows whose alive flag or Adam moments differ, and
    statistics not started again (an exact comparison); ``densify_gap``:
    the largest difference of a parameter over its field's largest
    magnitude, the worst field."""
    rows = prog["alive"] != ref["alive"]
    for m in ("mu", "nu"):
        for k, v in prog[m].items():
            rows |= (v != ref[m][k]).reshape(v.shape[0], -1).any(dim=1)
    rows |= (prog["accum"] != 0) | (prog["denom"] != 0)
    gap = 0.0
    for k in FIELDS + ("confidence",):
        d = float((prog[k].double() - ref[k].double()).abs().max())
        scale = float(ref[k].double().abs().max())
        gap = max(gap, d / max(scale, 1e-30) if math.isfinite(d) else math.inf)
    return {"densify_slots": int(rows.sum()), "densify_gap": gap}
