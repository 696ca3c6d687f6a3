"""idle_ms_per_iter.loop: milliseconds a training iteration in which the
device is idle in the loop's own time (train/loop.Trainer.train:
``train.iteration`` and ``train.step`` outside their children, the
pseudo prefetch, densify events, log points), over the profiled chunk
(benchmark/spans.py)."""

from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, "train", ("train.iteration", "train.step", "train.prefetch",
                                  "train.densify", "train.log"))
