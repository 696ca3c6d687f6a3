"""adam_ms_per_iter.device: ``adam_ms_per_iter`` (the fused Adam kernel's
device time an iteration in the profiled chunk) in a cell whose
end-to-end metric is ``train_device_ms_per_iter``."""

from benchmark.spec import reader

read = reader("adam_ms_per_iter")
