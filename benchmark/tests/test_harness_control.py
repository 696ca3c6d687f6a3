"""The control and the planted faults come out not correct: at a small
size on the CPU (the precision one step below emulated by the same
dispatch mode the card runs), and at each cell's own size on the card."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, control, spec

CELLS = ("llff-train-pseudo", "m360-train-plain", "llff-render", "llff-train-early",
         "m360-train-pseudo")


def verdicts(cell, seed: int, dev) -> dict:
    """Each fault's verdict over the numbers it reads (the jitter is a
    witness, not a fault)."""
    out = {}
    for mode, r in control.readings(cell, seed, dev).items():
        if mode != "jitter":
            limits = {k: v for k, v in cell.limits["limits"].items() if k in r}
            out[mode] = check.judge(r, {"limits": limits})[0]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_small_size(small_bench, name):
    v = verdicts(spec.load_cell(name, root=small_bench), 3, torch.device("cpu"))
    assert set(v) >= {"control", "altered"} and not any(v.values()), v
    if name == "llff-train-early":
        assert set(v) >= {"densify_frozen", "densify_unmoved", "proximity_skipped"}, v


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda_device, name):
    v = verdicts(spec.load_cell(name), 5, cuda_device)
    assert not any(v.values()), v
