"""k3_roofline_pct.render: K3's least time, the bytes it must move at the
HBM's 3.35 TB/s (benchmark/work.py), over its device time by name
(composite_fwd_kernel) in the profiled pass, in percent."""

from benchmark.work import HBM_BYTES_PER_S


def read(run):
    tr = run.trace
    if run.kind != "render" or tr is None or "k3_bytes_per_unit" not in run.work:
        return None
    seconds = tr.kernel_s("K3")
    if seconds <= 0:
        return None
    least = run.work["k3_bytes_per_unit"] * run.traced_units / HBM_BYTES_PER_S
    return 100.0 * least / seconds
