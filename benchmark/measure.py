"""What a run measured, as the metric readers read it."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from benchmark.tracing import Trace


@dataclass
class Run:
    kind: str                       # the traffic's generator: "train" or "render"
    setup_s: float = 0.0            # process start to the window's opening
    window_s: float = 0.0           # the window, host clock, ending in a synchronise
    units: int = 0                  # iterations (train) or views (render) in the window
    unit_s: float = 0.0             # host seconds a unit, timed with no bracket or profiler
    latencies_ms: list = field(default_factory=list)   # render: every view's latency
    trace: Optional[Trace] = None   # the profiled stretch after the window (render: every run)
    traced_units: int = 0           # iterations or views in the profiled stretch
    pseudo_units: int = 0           # pseudo iterations in the window
    brackets: dict = field(default_factory=dict)   # --trace 1: name -> [ms] over the window
    work: dict = field(default_factory=dict)       # --trace 1: bytes and operations per unit
    power_limit: str = "unknown"    # the card's power limit, beside every share
    phases: dict = field(default_factory=dict)     # seconds by stage of the run, for stderr

    def lap(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t0
        return now
