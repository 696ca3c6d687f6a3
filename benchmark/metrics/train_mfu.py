"""train_mfu: the whole iteration's least time at the published peaks (the
depth net's operations at 989 TFLOP/s bf16, the bytes of K1-K5, the losses
and Adam at 3.35 TB/s; benchmark/work.py) over the measured time per
iteration (host clock, a chunk without brackets or profiler), in percent."""

from benchmark.work import BF16_FLOPS, HBM_BYTES_PER_S


def read(run):
    w = run.work
    if run.kind != "train" or "bytes_per_unit" not in w or not run.units or not run.unit_s:
        return None
    pseudo_share = run.pseudo_units / run.units
    least = (w["bytes_per_unit"] / HBM_BYTES_PER_S
             + pseudo_share * w["flops_per_unit"] / BF16_FLOPS)
    return 100.0 * least / run.unit_s
