"""idle_ms_per_iter.facade: milliseconds a training iteration in which the
device is idle while ``render`` (the facade: K1-K3's launches, its small
ops, the output's assembly) is the innermost span open, over the profiled
chunk (benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ("render",))
