"""adam_ms_per_iter: the fused Adam kernel's device time
(``fused_adam_kernel``, by name) in the profiled chunk, in milliseconds,
over its iterations; None where no such kernel ran (a program that
updates by PyTorch's elementwise op chain)."""

from benchmark.tracing import kernel_matches

KERNEL = "fused_adam_kernel"


def read(run):
    tr = run.trace
    if run.kind != "train" or tr is None or not run.traced_units:
        return None
    seconds = sum(s for name, (s, _) in tr.by_name.items() if kernel_matches(name, KERNEL))
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units
