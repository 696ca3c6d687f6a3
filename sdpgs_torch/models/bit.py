"""BiT (Big Transfer) backbone: the convolutional stem of DPT-Hybrid.

Counterpart of ``sdpgs_tpu/models/bit.py:21-174`` (transformers
``BitBackbone`` with ``layer_type='bottleneck'``, ``stem_type='same'``):
weight-standardised convolutions with TF-style dynamic SAME padding,
GroupNorm (+ ReLU) and a SAME max-pool. Parameters carry the torch
state-dict names. JAX's stem-phase convolution (a TPU layout of the same
stride-2 convolution) is not carried over: the stem convolves the resized
image directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BitArch:
    embedding_size: int = 64
    hidden_sizes: Sequence[int] = (256, 512, 1024)
    depths: Sequence[int] = (3, 4, 9)
    num_groups: int = 32
    width_factor: int = 1


def _make_div(value, divisor=8):
    min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < 0.9 * value:
        new_value += divisor
    return new_value


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF dynamic SAME padding (transformers DynamicPad2d): the extra pixel
    of an odd total goes after."""
    H, W = x.shape[-2:]

    def pad_amount(n):
        return max((math.ceil(n / s) - 1) * s + k - n, 0)

    ph, pw = pad_amount(H), pad_amount(W)
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


class WSConv2d(nn.Module):
    """Bias-free convolution with weight standardisation (per output
    channel, biased variance, eps 1e-8) and dynamic SAME padding."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, k, k))
        self.k, self.stride = k, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = self.weight.reshape(self.weight.shape[0], -1)
        var, mu = torch.var_mean(flat, dim=1, keepdim=True, unbiased=False)
        w = ((flat - mu) / torch.sqrt(var + 1e-8)).reshape(self.weight.shape)
        return F.conv2d(_same_pad(x, self.k, self.stride), w, stride=self.stride)


class GroupNormAct(nn.GroupNorm):
    """GroupNorm (biased variance, eps 1e-5), then ReLU when ``act``."""

    def __init__(self, num_groups: int, channels: int, act: bool = True):
        super().__init__(num_groups, channels, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return F.relu(x) if self.act else x


def _maxpool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """Max-pool with TF dynamic SAME padding; the pad is 0, which after a
    ReLU never wins against the window's values (bit.py:85-99)."""
    return F.max_pool2d(_same_pad(x, k, s, value=0.0), k, stride=s)


class _Embedder(nn.Module):
    def __init__(self, arch: BitArch):
        super().__init__()
        emb = _make_div(arch.embedding_size * arch.width_factor)
        self.convolution = WSConv2d(3, emb, 7, 2)
        self.norm = GroupNormAct(arch.num_groups, emb)

    def forward(self, x):
        return _maxpool_same(self.norm(self.convolution(x)))


class _Downsample(nn.Module):
    def __init__(self, in_ch, out_ch, stride, groups):
        super().__init__()
        self.conv = WSConv2d(in_ch, out_ch, 1, stride)
        self.norm = GroupNormAct(groups, out_ch, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class BottleneckLayer(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with a projected shortcut on the first
    layer of a stage."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, first: bool, groups: int):
        super().__init__()
        mid = _make_div(out_ch / 4)
        if first:
            self.downsample = _Downsample(in_ch, out_ch, stride, groups)
        self.conv1 = WSConv2d(in_ch, mid, 1)
        self.norm1 = GroupNormAct(groups, mid)
        self.conv2 = WSConv2d(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(groups, mid)
        self.conv3 = WSConv2d(mid, out_ch, 1)
        self.norm3 = GroupNormAct(groups, out_ch, act=False)

    def forward(self, x):
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class _Stage(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Encoder(nn.Module):
    def __init__(self, arch: BitArch):
        super().__init__()
        stages, in_ch = [], _make_div(arch.embedding_size * arch.width_factor)
        for si, (depth, hidden) in enumerate(zip(arch.depths, arch.hidden_sizes)):
            out_ch = _make_div(hidden * arch.width_factor)
            stride = 1 if si == 0 else 2
            stages.append(_Stage([
                BottleneckLayer(in_ch if li == 0 else out_ch, out_ch, stride if li == 0 else 1,
                                li == 0, arch.num_groups)
                for li in range(depth)]))
            in_ch = out_ch
        self.stages = nn.ModuleList(stages)


class BitBackbone(nn.Module):
    """[B, 3, H, W] -> the feature map of every stage ([/4, /8, /16] for
    the 3-stage DPT-Hybrid configuration). State-dict keys:
    ``embedder.*`` and ``encoder.stages.{s}.layers.{l}.*``."""

    def __init__(self, arch: BitArch = BitArch()):
        super().__init__()
        self.arch = arch
        self.embedder = _Embedder(arch)
        self.encoder = _Encoder(arch)

    def out_channels(self) -> int:
        return _make_div(self.arch.hidden_sizes[-1] * self.arch.width_factor)

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        x = self.embedder(pixel_values)
        feats = []
        for stage in self.encoder.stages:
            for layer in stage.layers:
                x = layer(x)
            feats.append(x)
        return feats

