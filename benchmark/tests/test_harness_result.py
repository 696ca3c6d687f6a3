"""The result line, the refusal without a card, and the check's verdict
on a timed path broken underneath (the harness driven on the CPU at a
small size, its look for a chip skipped)."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import spec
from benchmark.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def drive(bench: Path, cell: str, trace: bool = False, seed: int = 7) -> dict:
    c = spec.load_cell(cell, root=bench)
    return run_cell(c, seed, 0.5, trace, torch.device("cpu"), time.perf_counter())


def test_train_line(small_bench):
    r = drive(small_bench, "m360-train-plain")
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    # the cell's end-to-end metrics are the card's time an iteration, from a
    # chunk profiled after the window (no device on the CPU: its reader
    # finds nothing), and the set-up
    assert "profiled" in r["phases"]
    assert set(r["metrics"]) == {"setup_s"}
    assert r["correct"] and r["attempted"] >= 100 and r["failed"] == 0
    assert set(r["checks"]) == {"loss_first", "loss_rel", "grad_gap", "change_gap"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def test_traced_render_line(small_bench):
    r = drive(small_bench, "llff-render", trace=True)
    assert list(r)[:5] == KEYS and "breakdown" in r and list(r)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the readers of the device trace find nothing
    assert set(r["metrics"]) <= {"render_mfu", "render_ms_p95", "render_views_per_s.host"}
    assert r["correct"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device: exit 2, nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "llff-render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.card
def test_benchmark_alone_fails(cuda_device, tmp_path):
    """In a folder holding only BENCHMARK.json and the benchmark: no
    program, so no result and a non-zero exit."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "llff-render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def frozen_step(monkeypatch):
    """A step that returns its state unchanged: Adam moves nothing."""
    import sdpgs_torch.opt.adam as adam
    import sdpgs_torch.train.step as step

    monkeypatch.setattr(step, "adam_update", lambda g, grads, state, lrs, **kw:
                        adam.GaussianAdamState(mu=state.mu, nu=state.nu, step=state.step + 1))


def altered_render(monkeypatch):
    """Every render altered where it is produced: its middle tile left out
    (black, depth and feature zero), as a compositor that skipped it."""
    import sdpgs_torch.ops.rasterize.rasterizer as rz
    import sdpgs_torch.render as render_mod

    real = rz.rasterize

    def rasterize(*a, **kw):
        out = real(*a, **kw)
        t = (kw.get("cfg") or a[8]).tile
        H, W = out.depth.shape
        y, x = (H // t // 2) * t, (W // t // 2) * t
        skip = {}
        for name in ("color", "depth", "feature"):
            v = getattr(out, name).clone()
            v[y:y + t, x:x + t] = 0.0
            skip[name] = v
        return out._replace(**skip)

    monkeypatch.setattr(render_mod, "rasterize", rasterize)


def no_pseudo(monkeypatch):
    """The pseudo view's half of each step's batch left out."""
    import sdpgs_torch.train.step as step

    monkeypatch.setattr(step, "_pseudo_losses", lambda out, *a, **kw:
                        torch.zeros((), device=out.depth.device))


def frozen_densify(monkeypatch):
    """A densify event that returns its state unchanged."""
    import sdpgs_torch.train.loop as loop
    from sdpgs_torch.opt.densify import DensifyInfo

    monkeypatch.setattr(loop, "densify_and_prune", lambda g, opt_state, stats, noise, **kw:
                        (g, opt_state, stats, DensifyInfo(*(
                            torch.zeros((), dtype=torch.int32) for _ in range(4)))))


def unmoved_children(monkeypatch):
    """A densify event whose split children are altered where they are
    made: left on their sources, the noise that moves them zeroed."""
    import sdpgs_torch.train.loop as loop

    real = loop.densify_and_prune
    monkeypatch.setattr(loop, "densify_and_prune", lambda g, opt_state, stats, noise, **kw:
                        real(g, opt_state, stats, torch.zeros_like(noise), **kw))


def no_proximity(monkeypatch):
    """A densify event without the proximity rule where the schedule runs
    it."""
    import sdpgs_torch.train.loop as loop

    real = loop.densify_and_prune
    monkeypatch.setattr(loop, "densify_and_prune", lambda *a, run_proximity, **kw:
                        real(*a, run_proximity=False, **kw))


def lower_depth_net(monkeypatch):
    """The program's depth net one precision below its configuration's
    (float8 products for its bfloat16 ones)."""
    from sdpgs_torch.models.depth_estimator import MonoDepth

    from benchmark.reference.precision import Lower

    real = MonoDepth.forward

    def forward(self, image):
        with Lower():
            return real(self, image)

    monkeypatch.setattr(MonoDepth, "forward", forward)


@pytest.mark.parametrize("cell, fault", [
    ("llff-train-pseudo", frozen_densify),
    ("llff-train-pseudo", unmoved_children),
    ("llff-train-pseudo", lower_depth_net),
    ("m360-train-plain", frozen_step),
    ("m360-train-plain", altered_render),
    ("llff-train-pseudo", frozen_step),
    ("llff-train-pseudo", altered_render),
    ("llff-train-pseudo", no_pseudo),
    ("llff-render", altered_render),
    ("llff-train-early", frozen_densify),
    ("llff-train-early", no_proximity),
    ("llff-train-early", altered_render),
    ("m360-train-pseudo", frozen_step),
    ("m360-train-pseudo", altered_render),
    ("m360-train-pseudo", no_pseudo),
    ("m360-train-pseudo", frozen_densify),
    ("m360-train-pseudo", unmoved_children),
    ("m360-train-pseudo", lower_depth_net),
])
def test_a_broken_path_is_not_correct(small_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = drive(small_bench, cell)
    assert not r["correct"], r["checks"]
