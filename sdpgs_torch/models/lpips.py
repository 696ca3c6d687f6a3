"""LPIPS perceptual distance with a VGG16 backbone.

Counterpart of ``sdpgs_tpu/models/lpips.py``: VGG16 convolution features at
five stages, each unit-normalized over channels, weighted by learned 1x1
heads, averaged over space and summed over stages. The weights are the
``.npz`` that ``tools/convert_lpips.py`` writes from torchvision's VGG16 and
LPIPS's linear heads (``conv{s}_{i}_w/b``, ``lin{s}_w``); nothing is
downloaded. The convolutions and the 2x2 max-pool are cuDNN's (the JAX
package computes them with XLA, outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 layout: (out_channels, convolutions) per stage, a pool after each but the last.
VGG16_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# LPIPS's input normalization (ImageNet-derived shift and scale).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """Frozen LPIPS-VGG; its weights are buffers on one device."""

    def __init__(self, params: Dict[str, np.ndarray],
                 stages: Sequence[Tuple[int, int]] = VGG16_STAGES, device=None):
        from sdpgs_torch import default_device

        super().__init__()
        dev = default_device(device)
        self.stages = [tuple(s) for s in stages]
        for k, v in params.items():
            self.register_buffer(k, torch.as_tensor(np.asarray(v, np.float32), device=dev))
        self.register_buffer("shift", torch.as_tensor(_SHIFT, device=dev)[:, None, None])
        self.register_buffer("scale", torch.as_tensor(_SCALE, device=dev)[:, None, None])

    @classmethod
    def load(cls, path, stages: Sequence[Tuple[int, int]] = VGG16_STAGES,
             device=None) -> "LPIPS":
        with np.load(path) as z:
            return cls(dict(z), stages, device=device)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N, 3, H, W] (or [3, H, W]) in [0, 1] -> each stage's activations."""
        h = x[None] if x.dim() == 3 else x
        h = h * 2.0 - 1.0                                  # LPIPS expects [-1, 1]
        h = (h - self.shift) / self.scale
        feats = []
        for s, (_, n_convs) in enumerate(self.stages):
            for i in range(n_convs):
                w, b = getattr(self, f"conv{s}_{i}_w"), getattr(self, f"conv{s}_{i}_b")
                h = F.relu(F.conv2d(h, w, padding=1) + b[None, :, None, None])
            feats.append(h)
            if s < len(self.stages) - 1:
                h = F.max_pool2d(h, 2)
        return feats

    @torch.no_grad()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """[3, H, W] pair in [0, 1] -> the scalar distance. Both images go
        through the network as one batch of two."""
        total = torch.zeros((), dtype=torch.float32, device=img1.device)
        for s, f in enumerate(self.features(torch.stack([img1, img2]))):
            f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
            diff = (f[0] - f[1]) ** 2
            total = total + torch.mean(torch.sum(diff * getattr(self, f"lin{s}_w")[0], dim=0))
        return total
