"""launches_per_iter.device: ``launches_per_iter`` (device operations per
training iteration over the profiled chunk) in a cell whose end-to-end
metric is ``train_device_ms_per_iter``."""

from benchmark.spec import reader

read = reader("launches_per_iter")
