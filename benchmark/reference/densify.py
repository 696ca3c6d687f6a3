"""The reference densify-and-prune event, with FSGS's proximity rule.

The semantics of ``sdpgs_torch/opt/densify.py:densify_and_prune`` and of
the reference's ``gaussian_model.py`` it follows, written out plainly:
the alive Gaussians whose mean screen gradient reaches the threshold are
cloned (small ones: one child, a copy) or split (large ones: two children
displaced by the noise rows of their ranks along the source's axes, their
scales over 1.6; the source dies). Before ``proximity_until_iter`` the
proximity rule (FSGS ``gaussian_model.py:514-518, 598-599``) adds three
children to every alive Gaussian larger than the extent whose mean squared
distance to its three nearest other alive Gaussians exceeds five extents:
child j at the midpoint of the source and its j-th neighbour, with that
neighbour's scaling, opacity and language feature, the identity rotation
and no colour. A source's children follow one another (clone or split
pair, then the three), sources in index order, and take the dead slots in
index order, as many as there are; then every Gaussian whose opacity is
under the floor is pruned; the Adam moments of new and dead rows are
zeroed and the statistics start again.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.raster import FIELDS

LOG_1_6 = float(torch.log(torch.tensor(1.6, dtype=torch.float32)))
KNN_ROWS = 256       # query rows a block of the exact k-NN


def rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] quaternions (w, x, y, z), normalised here -> [N, 3, 3]."""
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def nearest3(xyz: torch.Tensor, live: torch.Tensor, rows: torch.Tensor) -> tuple:
    """For each of ``rows``, its three nearest other alive Gaussians,
    exactly: squared distances in float64 (inf where fewer exist) and
    indices [len(rows), 3], nearest first, ties to the lower index."""
    pts = xyz.double().T
    d2s, idxs = [], []
    for block in torch.split(rows, KNN_ROWS):
        d2 = sum((pts[c, block, None] - pts[c, None, :]) ** 2 for c in range(3))
        d2[:, ~live] = torch.inf
        d2[torch.arange(block.numel(), device=xyz.device), block] = torch.inf
        d2, idx = torch.sort(d2, dim=1, stable=True)
        d2s.append(d2[:, :3])
        idxs.append(idx[:, :3])
    if not d2s:
        return xyz.new_zeros((0, 3), dtype=torch.float64), rows.new_zeros((0, 3))
    return torch.cat(d2s), torch.cat(idxs)


def proximity_sources(state: dict, extent: float) -> tuple:
    """The proximity rule: [P] the alive Gaussians larger than the extent
    whose mean finite squared distance to their three nearest other alive
    Gaussians exceeds five extents, and [P, 3] those neighbours (zero on
    the other rows: the rule reads them only where size and life hold)."""
    live = state["alive"] > 0
    big = live & (torch.exp(state["scaling"]).amax(dim=-1) > extent)
    rows = torch.nonzero(big).flatten()
    d2, idx = nearest3(state["xyz"], live, rows)
    finite = torch.isfinite(d2)
    mean = torch.where(finite, d2, 0.0).sum(-1) / finite.sum(-1).clamp_min(1)
    sources = torch.zeros_like(big)
    sources[rows] = mean > 5.0 * extent
    neighbors = torch.zeros(big.shape + (3,), dtype=torch.int64, device=big.device)
    neighbors[rows] = idx
    return sources, neighbors


@torch.no_grad()
def densify_and_prune(state: dict, noise: torch.Tensor, *, grad_threshold: float,
                      min_opacity: float, extent: float, percent_dense: float,
                      run_proximity: bool) -> dict:
    """``state``: the fields of ``FIELDS`` and ``confidence`` [P, ...],
    ``alive`` [P] (0 or 1), ``mu`` and ``nu`` (field -> [P, ...]),
    ``accum``, ``denom`` [P]; ``noise`` [P, 3]; ``run_proximity``: the event
    comes before ``proximity_until_iter``. Returns the state after the
    event, in new tensors, and under ``proximity_children`` (0-d) the
    number of children the rule asked for."""
    live = state["alive"] > 0
    P = live.shape[0]
    dev = live.device
    grads = torch.nan_to_num(torch.where(state["denom"] > 0,
                                         state["accum"] / state["denom"], 0.0))
    max_scale = torch.exp(state["scaling"]).amax(dim=-1)
    hit = live & (grads >= grad_threshold)
    small = max_scale <= percent_dense * extent
    clone = hit & small
    split = hit & (max_scale > percent_dense * extent)
    if run_proximity:
        prox, neighbors = proximity_sources(state, extent)
    else:
        prox = torch.zeros_like(live)
        neighbors = torch.zeros((P, 3), dtype=torch.int64, device=dev)

    # the children in the order of their sources: a clone's one or a
    # split's two, then the proximity rule's three; child n takes the n-th
    # dead slot and the n-th noise row
    per_source = clone.long() + 2 * split.long() + 3 * prox.long()
    src = torch.repeat_interleave(torch.arange(P, device=dev), per_source)
    first = torch.cumsum(per_source, 0) - per_source
    rank = torch.arange(src.numel(), device=dev) - first[src]
    free = torch.nonzero(~live).flatten()
    n = min(src.numel(), free.numel())
    src, slot, rank = src[:n], free[:n], rank[:n]
    j = rank - clone[src].long() - 2 * split[src].long()    # the proximity child's number
    is_prox = j >= 0
    is_split = split[src] & ~is_prox

    out = {k: state[k].clone() for k in FIELDS + ("confidence",)}
    for k in FIELDS:
        out[k][slot] = state[k][src]
    out["confidence"][slot] = 1.0
    s_src, s_slot = src[is_split], slot[is_split]
    offset = noise[:n][is_split] * torch.exp(state["scaling"][s_src])
    moved = torch.matmul(rotation(state["rotation"][s_src]), offset[:, :, None])[:, :, 0]
    out["xyz"][s_slot] = state["xyz"][s_src] + moved
    out["scaling"][s_slot] = state["scaling"][s_src] - LOG_1_6
    p_src, p_slot = src[is_prox], slot[is_prox]
    nb = neighbors[p_src, j[is_prox]]
    out["xyz"][p_slot] = (state["xyz"][p_src] + state["xyz"][nb]) * 0.5
    for k in ("scaling", "opacity", "language_feature"):
        out[k][p_slot] = state[k][nb]
    out["features_dc"][p_slot] = 0.0
    out["features_rest"][p_slot] = 0.0
    out["rotation"][p_slot] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)

    spawned = torch.zeros(P, dtype=torch.bool, device=dev)
    spawned[slot] = True
    alive = (live | spawned) & ~split
    alive = alive & ~(torch.sigmoid(out["opacity"][:, 0]) < min_opacity)
    out["alive"] = alive.to(torch.float32)
    keep = (~(spawned | ~alive)).to(torch.float32)
    for m in ("mu", "nu"):
        out[m] = {k: v * keep.reshape((-1,) + (1,) * (v.ndim - 1)) for k, v in state[m].items()}
    out["accum"] = torch.zeros_like(state["accum"])
    out["denom"] = torch.zeros_like(state["denom"])
    out["proximity_children"] = 3 * prox.sum()
    return out


def readings(prog: dict, ref: dict) -> dict:
    """``densify_slots``: rows whose alive flag or Adam moments differ, and
    statistics not started again (an exact comparison); ``densify_gap``:
    the largest difference of a parameter over its field's largest
    magnitude, the worst field; ``proximity_children``: the reference
    event's, printed beside them."""
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
    return {"densify_slots": int(rows.sum()), "densify_gap": gap,
            "proximity_children": int(ref["proximity_children"])}
