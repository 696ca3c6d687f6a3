"""idle_ms_per_iter.losses: milliseconds a training iteration in which the
device is idle in ``step.forward``'s own time (the losses and the pseudo
branch's Python around the renders; train/step.loss_and_grads), over the
profiled chunk (benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ("step.forward",))
