"""k3_ns_per_entry.train: K3's device time in the profiled chunk of a
training cell (composite_fwd_kernel), in nanoseconds, over the
(tile, Gaussian) entries the chunk's renders listed (the program's
``raster.entries`` spans); None where the program records no such span."""

from benchmark.raster_work import ns_per_entry


def read(run):
    return ns_per_entry(run, "K3")
