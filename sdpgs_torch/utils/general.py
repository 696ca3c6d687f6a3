"""General utilities (reference utils/general_utils.py counterparts), a
copy of ``sdpgs_tpu/utils/general.py``."""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np


def safe_state(quiet: bool = False, seed: int = 0) -> None:
    """Seed the host RNGs and timestamp stdout lines (reference
    general_utils.py:122-143 also seeds torch; the port's generators are
    explicit, so only ``random`` and ``numpy`` are seeded here)."""
    random.seed(seed)
    np.random.seed(seed)
    if not quiet:
        old_write = sys.stdout.write

        def write(x):
            if x.endswith("\n") and x != "\n":
                stamp = datetime.now().strftime("%d/%m %H:%M:%S")
                x = x.replace("\n", f" [{stamp}]\n")
            old_write(x)

        sys.stdout.write = write


def inverse_sigmoid_np(x: np.ndarray) -> np.ndarray:
    return np.log(x / (1.0 - x))
