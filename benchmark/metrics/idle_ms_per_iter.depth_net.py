"""idle_ms_per_iter.depth_net: milliseconds a training iteration in which
the device is idle in the depth net's forward and backward
(models/depth_estimator.MonoDepth; the backward on autograd's thread),
over the profiled chunk (benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ("depth_net.forward", "depth_net.backward"))
