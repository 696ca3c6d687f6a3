"""Spans at the port's layer boundaries, and ``torch.profiler`` traces.

Counterpart of ``sdpgs_tpu/utils/profiling.py``: ``trace`` writes a Chrome
trace (Perfetto, ``chrome://tracing``) under ``logdir``.

``span(name, unit=None, n=1)`` marks one phase of the program (a train
iteration, its step's forward, backward and update, a render, the depth
net, an event of the loop, a frame sent to the viewer). A span records
its name, its start and end in ``time.time_ns()`` (the clock of the
profiler's host and device events), its thread, its parent (the
innermost span open on its thread, or on another thread where its own
has none: the backward of autograd's device thread under the step's
backward), the request it belongs to (``request``, its parent's, or the
ordinal of its name among the stretch's top-level spans: the iteration
of a train span, the served view of a render) and ``n``, the work done at
that boundary (cameras for a prefetch refill, else 1). It records only:

- while ``torch.profiler`` runs: each span also enters
  ``torch.profiler.record_function(name)``, so it shows in the profiler's
  trace (``trace(logdir)``'s Chrome trace among them);
- inside ``recording()``: records only, without a profiler.

Otherwise a span costs a read of two flags and records nothing. The
records of the last stretch (a profiler session or an outermost
``recording()``; a new one clears them) are ``spans()``; at most
``MAX_SPANS`` are kept.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _prof

MAX_SPANS = 1 << 18

_lock = threading.Lock()
_buffer: List["Span"] = []
_generation = 0                  # the stretch the buffer belongs to
_ordinals: dict = {}             # top-level span name -> spans so far in the stretch
_open: dict = {}                 # thread ident -> its stack of open spans
_recording = 0                   # depth of recording() contexts


class Span:
    """One recorded span; ``end_ns`` is None while it is open. ``parent``
    is the ``id`` of the span that caused it in the same stretch."""

    __slots__ = ("id", "name", "unit", "n", "request", "thread", "parent", "start_ns",
                 "end_ns", "_rf", "_generation")

    def __init__(self, name: str, unit: Optional[str], n: int, request: Optional[int]):
        self.name, self.unit, self.n, self.request = name, unit, n, request
        self.id = self.parent = self.start_ns = self.end_ns = self._rf = None

    def __enter__(self) -> "Span":
        tid = threading.get_ident()   # get_native_id is a system call: 10-28 µs on the H100 host
        stack = _open.setdefault(tid, [])
        parent = stack[-1] if stack else _innermost_elsewhere(tid)
        with _lock:
            if parent is not None and parent._generation != _generation:
                parent = None
            if self.request is None:
                if parent is not None:
                    self.request = parent.request
                else:
                    self.request = _ordinals.get(self.name, 0)
                    _ordinals[self.name] = self.request + 1
            self._generation = _generation
            if len(_buffer) < MAX_SPANS:
                self.id = len(_buffer)
                _buffer.append(self)
            elif len(_buffer) == MAX_SPANS:
                warnings.warn(f"profiling: more than {MAX_SPANS} spans in one stretch; "
                              "later ones are not kept", RuntimeWarning, stacklevel=2)
                _buffer.append(None)    # warn once
        self.thread = tid
        self.parent = None if parent is None else parent.id
        if _prof._is_profiler_enabled:
            self._rf = _prof.record_function(self.name)
        self.start_ns = time.time_ns()
        stack.append(self)      # with its start: other threads read it
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.end_ns = time.time_ns()
        stack = _open.get(self.thread)
        if stack:
            if stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
        return False


class _Off:
    """The span of a stretch that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _innermost_elsewhere(tid: int) -> Optional[Span]:
    """The latest-started span open on another thread."""
    tops = [s[-1:] for t, s in list(_open.items()) if t != tid]    # [] or [top], at once
    return max((t[0] for t in tops if t), key=lambda s: s.start_ns, default=None)


def span(name: str, unit: Optional[str] = None, n: int = 1, request: Optional[int] = None):
    """A context manager that records one span while the profiler runs or
    inside ``recording()``, and does nothing otherwise. ``unit`` names
    what one such span is (``"iteration"``, ``"view"``), ``n`` the work
    done in it, ``request`` the identifier its children share."""
    if not (_recording or _prof._is_profiler_enabled):
        return _OFF
    return Span(name, unit, n, request)


def is_recording() -> bool:
    """Whether spans record now (the profiler runs, or inside ``recording()``)."""
    return bool(_recording or _prof._is_profiler_enabled)


def _new_stretch() -> None:
    global _buffer, _generation
    with _lock:
        _generation += 1
        _buffer = []
        _ordinals.clear()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans in the body without a profiler (no ``record_function``);
    the outermost one, outside a profiler session, begins a new stretch."""
    global _recording
    if not (_recording or _prof._is_profiler_enabled):
        _new_stretch()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> List[Span]:
    """The closed spans of the last stretch, in the order they opened."""
    return [s for s in _buffer if s is not None and s.end_ns is not None]


def _install_stretch_hook() -> None:
    """Begin a new stretch whenever a ``torch.profiler`` session starts to
    record (torch calls ``_run_on_profiler_start`` there)."""
    start = _prof._run_on_profiler_start
    if getattr(start, "_sdpgs_stretch", False):
        return

    def on_profiler_start():
        start()
        if not _recording:
            _new_stretch()

    on_profiler_start._sdpgs_stretch = True
    _prof._run_on_profiler_start = on_profiler_start


_install_stretch_hook()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Path]:
    """Profile the body on the host and, where CUDA is available, on the
    card; yield the path of the Chrome trace written under ``logdir`` when
    the body ends. The trace shows the body's spans by name."""
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
