"""DPT (dense prediction transformer) monocular depth estimation.

Counterpart of ``sdpgs_tpu/models/dpt.py:29-474``: the MiDaS 3.0 family
(DPT-Large, and DPT-Hybrid, the reference's default depth net,
utils/depth_utils.py:4) as an ``nn.Module``: a ViT encoder with four
hooked stages (on a BiT stem for the hybrid), readout-projected
reassembly, top-down fusion and the depth head. The module's
``state_dict()`` keys are exactly the JAX package's parameter names, the
torch ``DPTForDepthEstimation`` names, so ``load_state_dict`` carries
weights across both ways. The forward is differentiable in the image: the
pseudo-view loss backpropagates through the net (depth_utils.py:38-44).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdpgs_torch.models.bit import BitArch, BitBackbone, _make_div
from sdpgs_torch.ops.resize import resize2d


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

    @classmethod
    def large(cls) -> "DPTArch":
        return cls()

    @classmethod
    def hybrid(cls) -> "DPTArch":
        """DPT-Hybrid (Intel/dpt-hybrid-midas): ViT-Base on a 3-stage
        BiT-R50 stem whose features feed the two finest fusion branches."""
        return cls(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                   backbone_out_indices=(2, 5, 8, 11), neck_hidden_sizes=(256, 512, 768, 768),
                   reassemble_factors=(1, 1, 1, 0.5), is_hybrid=True, bit=BitArch())

    @classmethod
    def tiny(cls, **kw) -> "DPTArch":
        """Small configuration for equivalence tests."""
        return cls(hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
                   backbone_out_indices=(0, 1, 2, 3), neck_hidden_sizes=(8, 12, 24, 32),
                   fusion_hidden_size=16, **kw)

    @classmethod
    def tiny_hybrid(cls, **kw) -> "DPTArch":
        return cls(hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
                   backbone_out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 32, 32, 32),
                   reassemble_factors=(1, 1, 1, 0.5), fusion_hidden_size=16, is_hybrid=True,
                   bit=BitArch(embedding_size=16, hidden_sizes=(16, 32, 32), depths=(1, 1, 1),
                               num_groups=8), **kw)


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

    def __init__(self, arch: DPTArch = DPTArch.large(), image_size: int = 384):
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


def _image_size(p: Dict, arch: DPTArch) -> int:
    """The square image size the position embeddings were made for."""
    n = np.asarray(p["dpt.embeddings.position_embeddings"]).shape[1] - 1
    return int(round(math.sqrt(n))) * arch.patch_size


def random_params(arch: DPTArch = DPTArch.hybrid(), seed: int = 0,
                  image_size: int = 384) -> Dict[str, np.ndarray]:
    """Random weights with the exact names and shapes of the torch
    ``DPTForDepthEstimation`` state dict (the subset the forward uses):
    normal(0, 0.02) weights, zero biases, unit norms. The same draws in
    the same order as the JAX package's ``random_params``, so the same seed
    gives equal arrays."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def w(name, *shape):
        p[name] = rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    def zeros(name, *shape):
        p[name] = np.zeros(shape, np.float32)

    def ones(name, *shape):
        p[name] = np.ones(shape, np.float32)

    def linear(name, out_f, in_f):
        w(f"{name}.weight", out_f, in_f)
        zeros(f"{name}.bias", out_f)

    def conv(name, out_c, in_c, k, bias=True):
        w(f"{name}.weight", out_c, in_c, k, k)
        if bias:
            zeros(f"{name}.bias", out_c)

    def norm(name, c):
        ones(f"{name}.weight", c)
        zeros(f"{name}.bias", c)

    C, I = arch.hidden_size, arch.intermediate_size
    if arch.is_hybrid:
        bit = arch.bit
        pre = "dpt.embeddings.backbone.bit"
        emb = _make_div(bit.embedding_size * bit.width_factor)
        conv(f"{pre}.embedder.convolution", emb, 3, 7, bias=False)
        norm(f"{pre}.embedder.norm", emb)
        in_ch = emb
        for si, (depth, hidden) in enumerate(zip(bit.depths, bit.hidden_sizes)):
            out_ch = _make_div(hidden * bit.width_factor)
            mid_ch = _make_div(out_ch / 4)
            for li in range(depth):
                name = f"{pre}.encoder.stages.{si}.layers.{li}"
                if li == 0:
                    conv(f"{name}.downsample.conv", out_ch, in_ch, 1, bias=False)
                    norm(f"{name}.downsample.norm", out_ch)
                conv(f"{name}.conv1", mid_ch, in_ch, 1, bias=False)
                norm(f"{name}.norm1", mid_ch)
                conv(f"{name}.conv2", mid_ch, mid_ch, 3, bias=False)
                norm(f"{name}.norm2", mid_ch)
                conv(f"{name}.conv3", out_ch, mid_ch, 1, bias=False)
                norm(f"{name}.norm3", out_ch)
                in_ch = out_ch
        conv("dpt.embeddings.projection", C, in_ch, 1)
    else:
        conv("dpt.embeddings.patch_embeddings.projection", C, 3, arch.patch_size)
    n_tok = (image_size // arch.patch_size) ** 2
    w("dpt.embeddings.position_embeddings", 1, n_tok + 1, C)
    zeros("dpt.embeddings.cls_token", 1, 1, C)

    for i in range(arch.num_layers):
        pre = f"dpt.encoder.layer.{i}"
        norm(f"{pre}.layernorm_before", C)
        for nm in ("query", "key", "value"):
            linear(f"{pre}.attention.attention.{nm}", C, C)
        linear(f"{pre}.attention.output.dense", C, C)
        norm(f"{pre}.layernorm_after", C)
        linear(f"{pre}.intermediate.dense", I, C)
        linear(f"{pre}.output.dense", C, I)

    F_ = arch.fusion_hidden_size
    n_cnn = 2 if arch.is_hybrid else 0
    for i in range(4):
        nh = arch.neck_hidden_sizes[i]
        if i >= n_cnn:
            linear(f"neck.reassemble_stage.readout_projects.{i}.0", C, 2 * C)
            conv(f"neck.reassemble_stage.layers.{i}.projection", nh, C, 1)
            factor = arch.reassemble_factors[i]
            if factor > 1:
                k = int(factor)
                w(f"neck.reassemble_stage.layers.{i}.resize.weight", nh, nh, k, k)
                zeros(f"neck.reassemble_stage.layers.{i}.resize.bias", nh)
            elif factor < 1:
                conv(f"neck.reassemble_stage.layers.{i}.resize", nh, nh, 3)
        conv(f"neck.convs.{i}", F_, nh, 3, bias=False)
    for li in range(4):
        name = f"neck.fusion_stage.layers.{li}"
        for res in ("residual_layer1", "residual_layer2"):
            conv(f"{name}.{res}.convolution1", F_, F_, 3)
            conv(f"{name}.{res}.convolution2", F_, F_, 3)
        conv(f"{name}.projection", F_, F_, 1)

    conv("head.head.0", F_ // 2, F_, 3)
    conv("head.head.2", 32, F_ // 2, 3)
    conv("head.head.4", 1, 32, 1)
    return p


def save_params(path, params: Dict[str, np.ndarray], arch: Optional[DPTArch] = None) -> None:
    """Save a DPT state dict as .npz, with the architecture as a JSON
    ``__arch__`` entry when given (the JAX package's file format)."""
    out = {k: np.asarray(v) for k, v in params.items()}
    if arch is not None:
        out["__arch__"] = np.frombuffer(json.dumps(dataclasses.asdict(arch)).encode(),
                                        dtype=np.uint8)
    np.savez(path, **out)


def arch_from_json_bytes(raw: np.ndarray) -> DPTArch:
    """Rebuild a DPTArch from the ``__arch__`` npz entry."""
    d = json.loads(bytes(np.asarray(raw, np.uint8)).decode())
    bit = d.pop("bit", None)
    if bit is not None:
        bit = BitArch(**{k: tuple(v) if isinstance(v, list) else v for k, v in bit.items()})
    return DPTArch(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}, bit=bit)

