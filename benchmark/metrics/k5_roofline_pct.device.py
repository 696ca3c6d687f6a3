"""k5_roofline_pct.device: ``k5_roofline_pct`` (K5's least time at the
HBM's 3.35 TB/s over its device time by name in the profiled chunk) in a
cell whose end-to-end metric is ``train_device_ms_per_iter``."""

from benchmark.spec import reader

read = reader("k5_roofline_pct")
