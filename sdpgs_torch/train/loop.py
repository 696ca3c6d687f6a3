"""Training loop pieces.

Counterpart of ``sdpgs_tpu/train/loop.py:215-264``: the prefetch of the
reprojection z-buffers for the next pseudo cameras (the body of
``Trainer._next_pseudo_reproj``), as a function the ``Trainer`` will own.
The rest of the loop comes with the Trainer slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sdpgs_torch.core.camera import Camera
from sdpgs_torch.losses import reproject_fused_depth_batch

# Pseudo cameras are drawn without replacement from ~10k poses, so no
# z-buffer is ever reused: the next REPROJ_PREFETCH cameras' z-buffers are
# built in one call (one K6 launch on the card) and held in a bounded queue.
REPROJ_PREFETCH = 64


def prefetch_pseudo_reproj(train_depths: torch.Tensor, K: torch.Tensor, R_train: torch.Tensor,
                           t_train: torch.Tensor, cameras: Sequence[Camera]
                           ) -> List[Tuple[Camera, torch.Tensor, torch.Tensor]]:
    """The fused reprojection depth and weight ([H, W] each) of every
    pseudo camera in ``cameras``, from the train views' depths
    ([V, H, W]), intrinsics and world -> camera poses, on the depths'
    device. Returns [(camera, fused, weight)] in order.

    JAX's Trainer recomputes a camera whose rows fell outside its TPU
    z-buffer's displacement window one by one. The port's z-buffer has no
    window and scatters every row, so its outlier count is always 0 and is
    not read (reading it would synchronise the device with the host)."""
    dev = train_depths.device
    R = torch.stack([c.view[:3, :3] for c in cameras]).to(dev)
    t = torch.stack([c.view[:3, 3] for c in cameras]).to(dev)
    fused, weight, _ = reproject_fused_depth_batch(train_depths, K, R_train, t_train, R, t)
    return [(c, fused[j], weight[j]) for j, c in enumerate(cameras)]
