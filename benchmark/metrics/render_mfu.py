"""render_mfu: one view's least time at the published peaks (the bytes of
K1-K3 and of the float image read for its copy to the host, at 3.35 TB/s;
benchmark/work.py) over the measured time per view of the window (host
clock), in percent."""

from benchmark.work import HBM_BYTES_PER_S


def read(run):
    w = run.work
    if run.kind != "render" or "bytes_per_unit" not in w or not run.unit_s:
        return None
    return 100.0 * (w["bytes_per_unit"] / HBM_BYTES_PER_S) / run.unit_s
