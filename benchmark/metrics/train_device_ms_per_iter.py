"""train_device_ms_per_iter: the card's time a training iteration, in ms:
the device's busy time (the union of its operations: K1-K5, Adam, the
losses' and autograd's kernels) over a chunk of 100 iterations profiled
after the window (torch.profiler, CUPTI), per iteration. Copies between
pageable host memory and the card are left out: the host's staging sets
their length, not the card. For a cell whose host sets the pace, where
the window's rate spreads by more than half the largest bound from run to
run (``train_it_per_s.host`` reads it there)."""

import sys

PAGEABLE = ("Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)")


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not tr.device_ops or not run.traced_units:
        return None
    copy_s = sum(s for name, (s, _) in tr.by_name.items() if name.startswith(PAGEABLE))
    print(f"train_device_ms_per_iter: the copies to and from pageable host memory left out, "
          f"{1e3 * copy_s / run.traced_units:.4f} ms an iteration", file=sys.stderr)
    return 1e3 * tr.busy_s_without(PAGEABLE) / run.traced_units
