"""train_mfu.device: the whole iteration's least time at the published
peaks (as ``train_mfu`` counts it, benchmark/work.py) over the card's time
an iteration (``train_device_ms_per_iter``, in the profiled chunk), in
percent: the whole step's share of the peak that bounds the kernels'
rooflines in a cell whose end-to-end metric is the card's time."""

from benchmark.spec import reader
from benchmark.work import BF16_FLOPS, HBM_BYTES_PER_S


def read(run):
    w = run.work
    if run.kind != "train" or "bytes_per_unit" not in w or not run.units:
        return None
    device_ms = reader("train_device_ms_per_iter")(run)
    if not device_ms:
        return None
    least = (w["bytes_per_unit"] / HBM_BYTES_PER_S
             + run.pseudo_units / run.units * w["flops_per_unit"] / BF16_FLOPS)
    return 100.0 * least / (device_ms * 1e-3)
