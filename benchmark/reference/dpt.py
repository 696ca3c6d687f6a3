"""The DPT-Hybrid depth net in plain PyTorch: a BiT-R50 stem, a ViT-B/16
encoder, reassembly, fusion and the depth head, and the monocular-depth
wrapper of the pseudo-view loss (bicubic resizes to 384x512 and back).

Copied from ``sdpgs_torch/models/bit.py``, ``dpt.py``,
``depth_estimator.py`` (``MonoDepth``) and ``ops/resize.py``. The state
dict keys are the program's, so one set of weights loads into both.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---- resize (ops/resize.py) ----

def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel, torch's a = -0.75 convention."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0, a * (t ** 3 - 5.0 * t ** 2 + 8.0 * t - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, method: str = "bicubic",
                  align_corners: bool = False) -> np.ndarray:
    """[n_out, n_in] f32 interpolation matrix matching
    ``torch.nn.functional.interpolate`` along one axis."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    i = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        src = i * (n_in - 1) / (n_out - 1)
    else:
        src = (i + 0.5) * (n_in / n_out) - 0.5
        if method == "bilinear":
            # area_pixel_compute_source_index clamps at 0 for half-pixel
            # centres; bicubic keeps the raw coordinate and clamps indices
            src = np.maximum(src, 0.0)
    A = np.zeros((n_out, n_in), dtype=np.float64)
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0
    if method == "bicubic":
        taps = [(-1, _cubic_weight(1.0 + frac)), (0, _cubic_weight(frac)),
                (1, _cubic_weight(1.0 - frac)), (2, _cubic_weight(2.0 - frac))]
    elif method == "bilinear":
        taps = [(0, 1.0 - frac), (1, frac)]
    else:
        raise ValueError(f"unknown resize method {method!r}")
    rows = np.arange(n_out)
    for off, w in taps:
        np.add.at(A, (rows, np.clip(x0 + off, 0, n_in - 1)), w)
    return A.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_matrix(n_in: int, n_out: int, method: str, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # cached per device and type: a copy to the card on every call would
    # wait for the host each time
    return torch.from_numpy(resize_matrix(n_in, n_out, method, align_corners)).to(
        device=device, dtype=dtype)


def resize2d(x: torch.Tensor, out_h: int, out_w: int, method: str = "bicubic",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing two axes of ``x`` ([..., H, W]) with torch-parity
    weights, in ``x``'s type; linear, so its gradient is exact."""
    H, W = x.shape[-2], x.shape[-1]
    Ay = _device_matrix(H, out_h, method, align_corners, x.device, x.dtype)
    Ax = _device_matrix(W, out_w, method, align_corners, x.device, x.dtype)
    out = torch.matmul(torch.matmul(Ay, x.reshape(-1, H, W)), Ax.T)
    return out.reshape(x.shape[:-2] + (out_h, out_w))


# ---- BiT (models/bit.py) ----

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


class _BitEncoder(nn.Module):
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
        self.encoder = _BitEncoder(arch)

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


# ---- DPT (models/dpt.py) ----

@dataclasses.dataclass(frozen=True)
class DPTArch:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    backbone_out_indices: Sequence[int] = (5, 11, 17, 23)
    neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024)
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12
    is_hybrid: bool = False
    bit: Optional[BitArch] = None    # when is_hybrid


def _resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, align_corners: bool):
    return resize2d(x, out_h, out_w, method="bilinear", align_corners=align_corners)


def _conv3(in_ch: int, out_ch: int, bias: bool = True) -> nn.Conv2d:
    """3x3 stride-1 SAME convolution (symmetric pad 1)."""
    return nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=bias)


# --- the ViT encoder (dpt.encoder.layer.{i}.*) -----------------------------

class _SelfAttention(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(C, C), nn.Linear(C, C), nn.Linear(C, C)


class _Dense(nn.Module):
    def __init__(self, in_f: int, out_f: int):
        super().__init__()
        self.dense = nn.Linear(in_f, out_f)


class _Attention(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.attention = _SelfAttention(C)
        self.output = _Dense(C, C)


class ViTLayer(nn.Module):
    """Pre-norm transformer layer: softmax(q k^T / sqrt(d)) v with
    ``torch.matmul``, as JAX writes it, and the exact (erf) GELU."""

    def __init__(self, arch: DPTArch):
        super().__init__()
        C, eps = arch.hidden_size, arch.layer_norm_eps
        self.num_heads = arch.num_heads
        self.layernorm_before = nn.LayerNorm(C, eps=eps)
        self.attention = _Attention(C)
        self.layernorm_after = nn.LayerNorm(C, eps=eps)
        self.intermediate = _Dense(C, arch.intermediate_size)
        self.output = _Dense(arch.intermediate_size, C)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        dh = C // H
        att = self.attention.attention

        def heads(lin):
            return lin(x).reshape(B, N, H, dh).transpose(1, 2)

        q, k, v = heads(att.query), heads(att.key), heads(att.value)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.attention.output.dense(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attend(self.layernorm_before(x))
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)), approximate="none")
        return x + self.output.dense(h)


class _Encoder(nn.Module):
    def __init__(self, arch: DPTArch):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(arch) for _ in range(arch.num_layers))


class _PatchEmbeddings(nn.Module):
    def __init__(self, C: int, patch: int):
        super().__init__()
        self.projection = nn.Conv2d(3, C, patch, stride=patch)


class _Backbone(nn.Module):
    def __init__(self, bit: BitArch):
        super().__init__()
        self.bit = BitBackbone(bit)


class Embeddings(nn.Module):
    """Image -> tokens [B, N + 1, C] (and the BiT features of the two
    finest stages for the hybrid); position embeddings interpolated to the
    token grid (modeling_dpt.py:_resize_pos_embed)."""

    def __init__(self, arch: DPTArch, image_size: int = 384):
        super().__init__()
        C = arch.hidden_size
        self.is_hybrid = arch.is_hybrid
        if arch.is_hybrid:
            self.backbone = _Backbone(arch.bit)
            self.projection = nn.Conv2d(self.backbone.bit.out_channels(), C, 1)
        else:
            self.patch_embeddings = _PatchEmbeddings(C, arch.patch_size)
        n_tok = (image_size // arch.patch_size) ** 2
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_tok + 1, C))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))

    def forward(self, x: torch.Tensor):
        B = x.shape[0]
        cnn_feats: List[torch.Tensor] = []
        if self.is_hybrid:
            feats = self.backbone.bit(x)
            cnn_feats = feats[:2]
            feat = self.projection(feats[-1])
        else:
            feat = self.patch_embeddings.projection(x)
        _, C, gh, gw = feat.shape
        tokens = feat.reshape(B, C, gh * gw).transpose(1, 2)
        pos = self.position_embeddings
        pos_tok, pos_grid = pos[:, :1], pos[:, 1:]
        g0 = int(round(math.sqrt(pos_grid.shape[1])))
        if (g0, g0) != (gh, gw):
            grid = pos_grid.reshape(1, g0, g0, C).permute(0, 3, 1, 2)
            grid = _resize_bilinear(grid, gh, gw, align_corners=False)
            pos_grid = grid.reshape(1, C, gh * gw).transpose(1, 2)
        cls = self.cls_token.expand(B, 1, C)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + torch.cat([pos_tok, pos_grid], dim=1), gh, gw, cnn_feats


class _DPTBody(nn.Module):
    def __init__(self, arch: DPTArch, image_size: int):
        super().__init__()
        self.embeddings = Embeddings(arch, image_size)
        self.encoder = _Encoder(arch)


# --- the neck (neck.*) and the head (head.head.*) ---------------------------

class _ReassembleLayer(nn.Module):
    def __init__(self, C: int, nh: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(C, nh, 1)
        self.factor = factor
        if factor > 1:
            k = int(factor)   # kernel == stride == factor, weight [in, out, k, k]
            self.resize = nn.ConvTranspose2d(nh, nh, k, stride=k)
        elif factor < 1:
            self.resize = nn.Conv2d(nh, nh, 3, stride=2, padding=1)

    def forward(self, x):
        x = self.projection(x)
        return self.resize(x) if self.factor != 1 else x


class _Reassemble(nn.Module):
    def __init__(self, arch: DPTArch, n_cnn: int):
        super().__init__()
        C = arch.hidden_size
        idx = [str(i) for i in range(n_cnn, 4)]
        self.readout_projects = nn.ModuleDict(
            {i: nn.Sequential(nn.Linear(2 * C, C)) for i in idx})
        self.layers = nn.ModuleDict(
            {i: _ReassembleLayer(C, arch.neck_hidden_sizes[int(i)], arch.reassemble_factors[int(i)])
             for i in idx})


class _ResidualUnit(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.convolution1 = _conv3(F_, F_)
        self.convolution2 = _conv3(F_, F_)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class _FusionLayer(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.residual_layer1 = _ResidualUnit(F_)
        self.residual_layer2 = _ResidualUnit(F_)
        self.projection = nn.Conv2d(F_, F_, 1)


class _FusionStage(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.layers = nn.ModuleList(_FusionLayer(F_) for _ in range(4))


class _Neck(nn.Module):
    def __init__(self, arch: DPTArch, n_cnn: int):
        super().__init__()
        F_ = arch.fusion_hidden_size
        self.reassemble_stage = _Reassemble(arch, n_cnn)
        self.convs = nn.ModuleList(_conv3(nh, F_, bias=False) for nh in arch.neck_hidden_sizes)
        self.fusion_stage = _FusionStage(F_)


class _Head(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.head = nn.ModuleDict({"0": _conv3(F_, F_ // 2), "2": _conv3(F_ // 2, 32),
                                   "4": nn.Conv2d(32, 1, 1)})


class DPT(nn.Module):
    """DPT for depth: [B, 3, H, W] normalised image -> [B, H, W] inverse
    depth. ``state_dict()`` keys are the JAX package's parameter names."""

    def __init__(self, arch: DPTArch, image_size: int = 384):
        super().__init__()
        self.arch = arch
        self.n_cnn = 2 if arch.is_hybrid else 0
        self.dpt = _DPTBody(arch, image_size)
        self.neck = _Neck(arch, self.n_cnn)
        self.head = _Head(arch.fusion_hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        tokens, gh, gw, cnn_feats = self.dpt.embeddings(pixel_values)
        # hybrid: the two finest neck inputs come from the CNN stem, the rest
        # from the ViT hooks backbone_out_indices[2:] (modeling_dpt.py:1047-1058)
        hooks = arch.backbone_out_indices[2:] if arch.is_hybrid else arch.backbone_out_indices
        hooked = []
        x = tokens
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in hooks:
                hooked.append(x)

        # reassemble (modeling_dpt.py:555-597, readout_type='project')
        re = self.neck.reassemble_stage
        feats = list(cnn_feats)
        for j, h in enumerate(hooked):
            i = str(j + self.n_cnn)
            cls, grid = h[:, 0], h[:, 1:]
            B, N, C = grid.shape
            merged = torch.cat([grid, cls[:, None, :].expand(B, N, C)], dim=-1)
            proj = F.gelu(re.readout_projects[i](merged), approximate="none")
            feats.append(re.layers[i](proj.transpose(1, 2).reshape(B, C, gh, gw)))
        feats = [conv(fm) for conv, fm in zip(self.neck.convs, feats)]

        # fusion, top-down (modeling_dpt.py:622-758)
        fused = None
        for layer, fm in zip(self.neck.fusion_stage.layers, reversed(feats)):
            if fused is None:
                h = fm
            else:
                if fused.shape[2:] != fm.shape[2:]:
                    fused = _resize_bilinear(fused, fm.shape[2], fm.shape[3], align_corners=False)
                h = fm + layer.residual_layer1(fused)
            h = layer.residual_layer2(h)
            h = _resize_bilinear(h, h.shape[2] * 2, h.shape[3] * 2, align_corners=True)
            fused = layer.projection(h)

        # head (modeling_dpt.py:920-956)
        hd = self.head.head
        h = hd["0"](fused)
        h = _resize_bilinear(h, h.shape[2] * 2, h.shape[3] * 2, align_corners=True)
        h = F.relu(hd["2"](h))
        h = F.relu(hd["4"](h))
        return h[:, 0]


# ---- MonoDepth (models/depth_estimator.py) ----

class MonoDepth(nn.Module):
    """A frozen DPT in ``dtype`` (f32 in and out).

    With ``dtype=torch.bfloat16`` the weights and the net's compute are
    bf16; the final resize back to H x W runs in f32, so the returned
    map's fidelity is the net's, not a bf16 resize's
    (depth_estimator.py:107-119). ``resize_method`` "bicubic" matches the
    reference's ``F.interpolate(..., mode="bicubic")`` in and out resizes;
    "bilinear" the JAX package's older behaviour, its ``DPTDepthModel``."""

    def __init__(self, net: DPT, dtype: Optional[torch.dtype] = None,
                 resize_method: str = "bicubic"):
        super().__init__()
        if resize_method not in ("bicubic", "bilinear"):
            raise ValueError(f"unknown resize method {resize_method!r}")
        self.net = net.to(dtype) if dtype is not None else net
        self.net.requires_grad_(False)
        self.dtype = dtype
        self.resize_method = resize_method

    @property
    def arch(self) -> DPTArch:
        return self.net.arch

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        H, W = image.shape[1:]
        img = image[None] if self.dtype is None else image[None].to(self.dtype)
        if self.resize_method == "bilinear":
            x = (_resize_bilinear(img, 384, 512, align_corners=False) - 0.5) / 0.5
        elif self.arch.is_hybrid:
            # JAX's default hybrid path normalises before the resize (the
            # two commute: interpolation rows sum to 1); keep its order
            x = resize2d((img - 0.5) / 0.5, 384, 512, "bicubic", align_corners=False)
        else:
            x = (resize2d(img, 384, 512, "bicubic", align_corners=False) - 0.5) / 0.5
        depth = self.net(x).to(torch.float32)
        if self.resize_method == "bilinear":
            out = _resize_bilinear(depth[:, None], H, W, align_corners=False)
        else:
            out = resize2d(depth[:, None], H, W, "bicubic", align_corners=False)
        return out[0, 0]
