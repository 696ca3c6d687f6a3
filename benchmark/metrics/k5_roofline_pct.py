"""k5_roofline_pct: K5's least time, the bytes it must move at the HBM's
3.35 TB/s (benchmark/work.py, at the entries the state lists), over its
device time by name (composite_bwd_kernel, entry_map_kernel,
reduce_kernel) in the profiled chunk, in percent."""

from benchmark.work import HBM_BYTES_PER_S


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or "k5_bytes_per_unit" not in run.work:
        return None
    seconds = tr.kernel_s("K5")
    if seconds <= 0:
        return None
    least = run.work["k5_bytes_per_unit"] * run.traced_units / HBM_BYTES_PER_S
    return 100.0 * least / seconds
