"""The monocular depth estimator of the pseudo-view loss.

Counterpart of ``sdpgs_tpu/models/depth_estimator.py:21-148`` (the
reference's ``utils/depth_utils.estimate_depth``: MiDaS DPT, frozen,
384x512 in and out, differentiable in the image in train mode).
:class:`MonoDepth` holds the net and its weights: [3, H, W] in [0, 1] ->
[H, W] inverse depth. The weights are frozen; the gradient flows to the
image only. Loading is explicit: :func:`make_mono_depth_fn` reads a
converted ``.npz`` and returns ``None`` without one (the train step then
keeps only the reprojection term).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from sdpgs_torch.models.dpt import DPT, DPTArch, _image_size, _resize_bilinear, arch_from_json_bytes
from sdpgs_torch.ops.resize import resize2d
from sdpgs_torch.utils.profiling import is_recording, span

MATMUL_PRECISIONS = ("default", "highest")


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
        with span("depth_net.forward"):
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
            out = out[0, 0]
        if is_recording() and img.requires_grad and out.requires_grad:
            _span_backward(img, out)
        return out


def _span_backward(img: torch.Tensor, out: torch.Tensor) -> None:
    """The ``depth_net.backward`` span, opened when the gradient reaches
    the net's output and closed when it has passed back to its input, on
    the thread that runs autograd's backward (a device thread on CUDA)."""
    s = span("depth_net.backward")

    def opened(grad):
        s.__enter__()

    def closed(grad):
        s.__exit__(None, None, None)

    out.register_hook(opened)
    img.register_hook(closed)


def mono_depth_from_params(raw: dict, arch: Optional[DPTArch] = None,
                           dtype: Optional[torch.dtype] = None,
                           matmul_precision: str = "default",
                           resize_method: str = "bicubic", device=None) -> MonoDepth:
    """A :class:`MonoDepth` from an in-memory state dict (numpy arrays under
    the DPT parameter names), on ``device`` (``cuda`` unless the caller asks
    for another). Without ``arch`` the keys decide between hybrid and
    large.

    ``matmul_precision`` is accepted for the JAX signature: the port keeps
    TF32 off, so an f32 net runs in full f32 either way, and ``dtype``
    (bf16) is the speed knob."""
    from sdpgs_torch import default_device

    if matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision {matmul_precision!r}: the port takes "
                         f"{MATMUL_PRECISIONS}")
    dev = default_device(device)
    if arch is None:
        arch = (DPTArch.hybrid() if any(k.startswith("dpt.embeddings.backbone.") for k in raw)
                else DPTArch.large())
    net = DPT(arch, image_size=_image_size(raw, arch))
    net.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in raw.items()})
    return MonoDepth(net.to(dev), dtype=dtype, resize_method=resize_method)


def make_mono_depth_fn(weights_path: Optional[str] = None, dtype: Optional[torch.dtype] = None,
                       matmul_precision: str = "default", resize_method: str = "bicubic",
                       device=None) -> Optional[MonoDepth]:
    """Load a converted DPT checkpoint (``.npz``, the JAX package's format,
    with an optional ``__arch__`` entry) as a :class:`MonoDepth`; ``None``
    when there is no file."""
    if not weights_path or not Path(weights_path).exists():
        return None
    raw = dict(np.load(weights_path))
    arch = arch_from_json_bytes(raw.pop("__arch__")) if "__arch__" in raw else None
    return mono_depth_from_params(raw, arch=arch, dtype=dtype, matmul_precision=matmul_precision,
                                  resize_method=resize_method, device=device)
