"""idle_ms_per_iter.update: milliseconds a training iteration in which the
device is idle in ``step.update`` (Adam, the densification statistics,
the step's metrics), over the profiled chunk (benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ("step.update",))
