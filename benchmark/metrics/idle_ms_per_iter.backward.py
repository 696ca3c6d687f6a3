"""idle_ms_per_iter.backward: milliseconds a training iteration in which
the device is idle in ``step.backward``'s own time (autograd's backward of
the loss, K5 and K4 among it; the depth net's backward left out), over
the profiled chunk (benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ("step.backward",))
