"""Evaluation metrics: the LPIPS hook the Trainer reads.

Counterpart of ``sdpgs_tpu/eval/metrics.py:44-54`` (``make_lpips_fn``). The
rest of that module (the metrics harness over saved renders) and the LPIPS
network come with the eval slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def make_lpips_fn(weights_path: Optional[str] = None):
    """A callable (img [3, H, W], gt [3, H, W]) -> float or None. Without
    converted VGG16 weights (no path, or no file there) it returns None for
    every pair, as JAX does, rather than a random network's distance. With
    weights it raises: the LPIPS network is not ported yet."""
    if weights_path is None or not Path(weights_path).exists():
        return lambda a, b: None
    raise NotImplementedError(
        "LPIPS with weights comes with the eval slice (ROADMAP.md queue A, item 12)")
