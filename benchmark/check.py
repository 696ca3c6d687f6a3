"""The comparisons that decide ``correct``, and their readings.

Training (the first three steps of the object the window then drives,
followed by the reference from the same state and inputs):
- ``loss_first``: the relative gap of the first step's loss (from the
  very state both sides were handed);
- ``l1_first``: the same of the first step's train-view L1, which no depth
  net touches;
- ``loss_rel``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step, over 1 - beta1, the moments starting at zero), the gap of
  each leaf's norm against the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
- ``change_gap``: the same of the parameters' change over the three steps;
- ``change_first``: the same of the change over the first step, which
  Adam's first update makes nearly a sign per element: steady where a
  cell's later steps inherit a chaotic gradient (the pseudo cell's
  bfloat16 depth net);
- ``net_out``, ``net_grad`` (pseudo iterations): the depth net's first
  call in the program, its output and its input gradient, against the
  reference net's on the same input and output gradient, as relative
  norms of the difference (``train_cell.net_readings``);
- ``densify_slots``, ``densify_gap`` (a densify event in set-up): the
  program's state after the first event past the checked steps against
  the reference event's from the program's state before it, with FSGS's
  proximity rule where the event comes before ``proximity_until_iter``
  (``reference/densify.readings``).
A cell compares the numbers its limits name; one that a run did not
read fails.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the gaps.

Rendering (a sample, drawn from the seed, of the views the window served,
against the reference's render of the same pose, both as 8-bit RGB):
- ``rgb_mean_lsb``: the mean absolute difference in units of 1/255.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference.raster import FIELDS
from benchmark.reference.step import B1

SILENT_LEAF = 1e-3


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(d[k].double())) for k in FIELDS}


def leaf_gaps(got: dict, ref: dict, counted) -> dict:
    med = statistics.median(ref[k] for k in FIELDS)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in counted}


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [3], "l1": [3], "mu1": field -> tensor,
    "change1", "change": field -> tensor (parameters after one and after
    three steps minus before)}."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    steps = [rel(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    g_prog = norms({k: v / (1 - B1) for k, v in prog["mu1"].items()})
    g_ref = norms({k: v / (1 - B1) for k, v in ref["mu1"].items()})
    med = statistics.median(g_ref[k] for k in FIELDS)
    counted = [k for k in FIELDS if g_ref[k] >= SILENT_LEAF * med]
    grad = leaf_gaps(g_prog, g_ref, counted)
    change = leaf_gaps(norms(prog["change"]), norms(ref["change"]), counted)
    first = leaf_gaps(norms(prog["change1"]), norms(ref["change1"]), counted)
    return {"loss_first": steps[0], "l1_first": rel(prog["l1"][0], ref["l1"][0]),
            "loss_rel": max(steps), "grad_gap": max(grad.values()),
            "change_gap": max(change.values()), "change_first": max(first.values()),
            "loss_rel_by_step": steps, "grad_gap_by_leaf": grad, "change_gap_by_leaf": change}


def render_readings(prog_imgs: list, ref_imgs: list) -> dict:
    diffs = [(a.to(torch.int16) - b.to(torch.int16)).abs() for a, b in zip(prog_imgs, ref_imgs)]
    total = sum(int(d.sum()) for d in diffs)
    count = sum(d.numel() for d in diffs)
    return {"rgb_mean_lsb": total / count, "rgb_max_lsb": max(int(d.max()) for d in diffs)}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    checks, ok = {}, True
    for name, lim in limits["limits"].items():
        v = float(readings.get(name, float("nan")))
        checks[name] = {"value": v, "limit": lim}
        ok = ok and v == v and v <= lim
    return ok, checks
