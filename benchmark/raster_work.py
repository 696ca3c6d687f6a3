"""Device time a listed (tile, Gaussian) entry: a kernel's time by name in
the profiled chunk (``tracing.Trace.kernel_s``) over the entries the
chunk's renders listed, which the program records as the ``n`` of its
``raster.entries`` spans (``sdpgs_torch/train/loop.Trainer``, one at each
log point, covering the renders since the last; a chunk ends on one)."""

from __future__ import annotations


def ns_per_entry(run, kernel: str):
    """Nanoseconds of ``kernel`` (``tracing.KERNELS``) an entry; None where
    the program records no ``raster.entries`` span or the kernel did not
    run."""
    tr = run.trace
    if run.kind != "train" or tr is None:
        return None
    try:
        from sdpgs_torch.utils.profiling import spans
    except ImportError:     # a program without spans
        return None
    entries = sum(s.n for s in spans() if s.name == "raster.entries")
    seconds = tr.kernel_s(kernel)
    if entries <= 0 or seconds <= 0:
        return None
    return seconds * 1e9 / entries
