"""Profiling hooks: ``torch.profiler`` traces and per-section wall timing.

Counterpart of ``sdpgs_tpu/utils/profiling.py``: ``trace`` writes a Chrome
trace (Perfetto, ``chrome://tracing``) under ``logdir``; ``StepTimer``
waits for the device of the tensors it is handed, as JAX's
``block_until_ready`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Path]:
    """Profile the body on the host and, where CUDA is available, on the
    card; yield the path of the Chrome trace written under ``logdir`` when
    the body ends."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a
    tensor, or a dict, list, tuple or dataclass of them); a CPU tensor is
    ready when its op returns."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """EMA and aggregate wall time per section, after a device sync."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Dict[str, float] = {}
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync_result=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync_result is not None:
            synchronize(sync_result)
        dt = time.perf_counter() - t0
        self.total[name] += dt
        self.count[name] += 1
        self.avg[name] = (
            dt if name not in self.avg
            else self.ema * self.avg[name] + (1 - self.ema) * dt
        )

    def summary(self) -> Dict[str, float]:
        return {k: self.total[k] / max(self.count[k], 1) for k in self.total}

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v * 1000:.1f}ms" for k, v in sorted(self.summary().items())
        )
