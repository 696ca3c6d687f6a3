"""The compositor's payload: the one layout between the preprocess and the
compositor.

Every Gaussian becomes one [NPAY] f32 row of the [P+1, NPAY] payload that
K3 and K5 (``csrc/composite*.cu``) gather by table entry, row P the zero
sentinel; binning reads the contiguous :class:`Screen` arrays beside it.
K1 (``csrc/preprocess.cu``) writes both, K4 (``csrc/preprocess_bwd.cu``)
reads the payload's gradient, and the plain versions
(``preprocess_cuda.preprocess_payload_plain``, ``composite_cuda``) read the
columns below. ``csrc/common.cuh`` repeats the column map for the kernels
(``SDPGS_PAY_*``); ``tests/test_torch_payload.py`` holds the two equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# column map: mean2d xy, conic abc, opacity*valid, rgb, depth, feature xyz
MEAN2D = slice(0, 2)
CONIC = slice(2, 5)
OPACITY = 5
RGB = slice(6, 9)
DEPTH = 9
FEATURE = slice(10, 13)
NPAY = 13
# the composited channels, a contiguous run of the row: rgb, depth, feature
VALUES = slice(RGB.start, FEATURE.stop)


class Screen(NamedTuple):
    """What binning and ``RenderOutput`` read of the preprocess: contiguous
    [P] and [P, 2] arrays, no gradient."""

    valid: torch.Tensor   # [P] bool: in front of the near plane, det != 0, radius > 0, alive
    mean2d: torch.Tensor  # [P, 2] pixel-space centre, the screen offset added
    depth: torch.Tensor   # [P] view-space z
    radius: torch.Tensor  # [P] 3-sigma screen radius (pixels, ceil; 0 where not valid)


class Payload(NamedTuple):
    """One view's preprocess: the [P+1, NPAY] rows (differentiable) and the
    binning record."""

    rows: torch.Tensor
    screen: Screen


def pad_row(a: torch.Tensor) -> torch.Tensor:
    """Append one zero 'dead' row: binning's sentinel index P points here."""
    return torch.cat([a, torch.zeros_like(a[:1])], dim=0)


def make_payload(prep, opacity, color, feature) -> torch.Tensor:
    """The plain assembly of the [P+1, NPAY] rows from a preprocess's
    ``mean2d``, ``conic``, ``valid`` and ``depth`` (a ``Preprocessed``) and
    the per-Gaussian opacity [P], colour [P, 3] and feature [P, 3]."""
    return pad_row(torch.cat([
        prep.mean2d,                              # MEAN2D
        prep.conic,                               # CONIC
        (opacity * prep.valid)[:, None],          # OPACITY
        color,                                    # RGB
        prep.depth[:, None],                      # DEPTH
        feature,                                  # FEATURE
    ], dim=-1).to(torch.float32)).contiguous()


def screen_of(prep) -> Screen:
    """The binning record of a plain preprocess (a ``Preprocessed``), detached."""
    return Screen(valid=prep.valid.detach(), mean2d=prep.mean2d.detach(),
                  depth=prep.depth.detach(), radius=prep.radius.detach())
