"""The device's idle time in a profiled stretch, put down to the program's
spans (``sdpgs_torch.utils.profiling.spans()``, recorded while the
profiler ran).

The idle gaps are the complement of the union of the device's operations
(``run.trace.ops``: microseconds on the Unix-epoch clock of the profiler,
which the spans' ``time.time_ns()`` shares) between the first span's start
and the last span's end. Each idle moment goes to the innermost span open
in it across the program's threads (the latest-started one not yet
ended), so a span keeps only the idle its children leave. ``idle_ms(run,
kind, names)`` is the idle that the spans of ``names`` hold, over the
stretch's units; it is None where the program records no such span (a
program without spans). The first reading of a stretch prints one line to
standard error: the idle a unit by span name, the idle outside every span,
their sum beside the stretch's total idle, and the device time a unit of
every ``Memcpy DtoH`` operation by the innermost span open at its middle
(a copy to pageable memory blocks the host thread that issued it).
"""

from __future__ import annotations

import heapq
import sys
from dataclasses import dataclass

OUTSIDE = "(outside every span)"
COPY = "Memcpy DtoH"


@dataclass
class Attribution:
    idle_us: dict        # span name -> the idle it holds, µs
    outside_us: float    # idle outside every span, µs
    total_us: float      # the stretch's idle, µs
    stretch_us: float    # first span's start to last span's end, µs
    copies: dict         # (span name or OUTSIDE, operation name) -> [µs, count]
    names: set           # every span name of the stretch


def idle_gaps(ops, t0: float, t1: float) -> list:
    """(start, end) of every stretch of [t0, t1] in which no operation of
    ``ops`` ((name, start, end), sorted by start) runs."""
    gaps, cur = [], t0
    for _, a, b in ops:
        if a >= t1:
            break
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            cur = b
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


def _push_started(heap, spans, j, t):
    """Push the spans (start, end, id, name; sorted by start, id) that
    started at or before ``t``, from index ``j``; drop ended ones from the
    top. The top is then the innermost span open at ``t``."""
    while j < len(spans) and spans[j][0] <= t:
        s = spans[j]
        heapq.heappush(heap, (-s[0], -s[2], s[1], s[3]))
        j += 1
    while heap and heap[0][2] <= t:
        heapq.heappop(heap)
    return j


def attribute_idle(gaps, spans) -> tuple:
    """The idle of ``gaps`` by the innermost open span: ({name: µs}, µs
    outside every span). ``spans``: (start, end, id, name), sorted by
    (start, id); of two spans that start together the later id is inner."""
    by_name, outside, heap, j = {}, 0.0, [], 0
    for a, b in gaps:
        t = a
        while t < b:
            j = _push_started(heap, spans, j, t)
            nxt = b
            if j < len(spans) and spans[j][0] < nxt:
                nxt = spans[j][0]
            if heap and heap[0][2] < nxt:
                nxt = heap[0][2]
            if heap:
                name = heap[0][3]
                by_name[name] = by_name.get(name, 0.0) + (nxt - t)
            else:
                outside += nxt - t
            t = nxt
    return by_name, outside


def owners_at(points, spans) -> list:
    """The innermost span's name open at each of ``points`` (sorted), or
    None outside every span."""
    heap, j, out = [], 0, []
    for p in points:
        j = _push_started(heap, spans, j, p)
        out.append(heap[0][3] if heap else None)
    return out


def attribute(ops, records):
    """The stretch of ``records`` (spans with ``name``, ``id``, ``start_ns``
    and ``end_ns``) against ``ops`` ((name, start µs, end µs) on the same
    epoch clock, sorted by start), or None if they do not overlap. Times
    are taken from the first span's start, so that sums keep their
    digits."""
    if not records or not ops:
        return None
    origin_ns = min(r.start_ns for r in records)
    origin = origin_ns * 1e-3
    spans = sorted(((r.start_ns - origin_ns) * 1e-3, (r.end_ns - origin_ns) * 1e-3, r.id,
                    r.name) for r in records)
    t1 = max(s[1] for s in spans)
    ops = [(n, a - origin, b - origin) for n, a, b in ops]
    if ops[0][1] >= t1 or max(b for _, _, b in ops) <= 0.0:
        return None
    gaps = idle_gaps(ops, 0.0, t1)
    by_name, outside = attribute_idle(gaps, spans)
    copies = {}
    held = [(0.5 * (a + b), n, b - a) for n, a, b in ops if n.startswith(COPY)]
    held.sort()
    for (_, op, us), owner in zip(held, owners_at([h[0] for h in held], spans)):
        c = copies.setdefault((owner or OUTSIDE, op), [0.0, 0])
        c[0] += us
        c[1] += 1
    return Attribution(idle_us=by_name, outside_us=outside,
                       total_us=sum(b - a for a, b in gaps), stretch_us=t1,
                       copies=copies, names={s[3] for s in spans})


def line(att: Attribution, units: int, unit: str) -> str:
    """The stretch on one line, in ms a unit."""
    per = 1e-3 / units
    idle = ", ".join(f"{n} {us * per:.6f}" for n, us in
                     sorted(att.idle_us.items(), key=lambda x: -x[1]))
    phases = sum(att.idle_us.values())
    copies = ", ".join(f"{n} [{op}] {us * per:.6f} ({k})" for (n, op), (us, k) in
                       sorted(att.copies.items(), key=lambda x: -x[1][0])) or "none"
    return (f"spans: {units} {unit}s, stretch {att.stretch_us * 1e-3:.3f} ms; idle ms a {unit} "
            f"by innermost span: {idle}; {OUTSIDE} {att.outside_us * per:.6f}; phases + "
            f"outside {(phases + att.outside_us) * per:.9f} = total idle "
            f"{att.total_us * per:.9f}; {COPY} device ms a {unit} by innermost span: {copies}")


_last: list = [None, None]     # the trace last read and its Attribution


def stretch(run):
    """The Attribution of the run's profiled stretch, computed once."""
    if _last[0] is run.trace:
        return _last[1]
    try:
        from sdpgs_torch.utils.profiling import spans
    except ImportError:     # a program without spans
        att = None
    else:
        att = attribute(run.trace.ops, spans())
        if att is not None:
            unit = "iteration" if run.kind == "train" else "view"
            print(line(att, run.traced_units, unit), file=sys.stderr)
    _last[:] = [run.trace, att]
    return att


def idle_ms(run, kind: str, names) -> float | None:
    """Milliseconds of idle a traced unit that the spans of ``names`` hold."""
    tr = run.trace
    if run.kind != kind or tr is None or not tr.ops or not run.traced_units:
        return None
    att = stretch(run)
    if att is None or not att.names & set(names):
        return None
    return sum(att.idle_us.get(n, 0.0) for n in names) * 1e-3 / run.traced_units
