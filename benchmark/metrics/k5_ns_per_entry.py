"""k5_ns_per_entry: K5's device time in the profiled chunk
(composite_bwd_kernel, entry_map_kernel, reduce_kernel: the kernels
k5_roofline_pct times), in nanoseconds, over the (tile, Gaussian) entries
the chunk's renders listed (the program's ``raster.entries`` spans); None
where the program records no such span."""

from benchmark.raster_work import ns_per_entry


def read(run):
    return ns_per_entry(run, "K5")
