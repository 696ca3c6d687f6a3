"""The monocular depth estimator of the pseudo-view loss.

Counterpart of ``sdpgs_tpu/models/depth_estimator.py:21-148`` (the
reference's ``utils/depth_utils.estimate_depth``: MiDaS DPT, frozen,
384x512 in and out, differentiable in the image in train mode).
:class:`MonoDepth` holds the net and its weights: [3, H, W] in [0, 1] ->
[H, W] inverse depth. The weights are frozen; the gradient flows to the
image only. Loading is explicit: :func:`make_mono_depth_fn` reads a
converted ``.npz`` and returns ``None`` without one (the train step then
keeps only the reprojection term).

On the card, a call whose image requires grad with grad enabled (the
pseudo step's) replays CUDA graphs: the first such call at an input
layout (shape, strides, type, device) captures the whole differentiable
call, forward and gradient with respect to the image, into one private
memory pool (:class:`_Graphed`), and later calls copy the image in and
launch the forward graph, and autograd's backward the gradient graph:
two launches where the eager net makes about 2,400. The kernels are the
eager path's, on the same inputs, so the results are bit-equal to it.
Each replay records an empty ``depth_net.replay`` span once it is launched.
Every other call (the CPU, ``no_grad``, an image without grad, a call
while an earlier replay still awaits its backward) runs eagerly.
"""

from __future__ import annotations

import threading
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
        self._graphs = {}       # input layout -> _Graphed

    @property
    def arch(self) -> DPTArch:
        return self.net.arch

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        with span("depth_net.forward"):
            if image.is_cuda and image.requires_grad and torch.is_grad_enabled():
                lease = self._graphed(image).lease()
                if lease is not None:
                    return _Replay.apply(image, lease)
            img, out = self._run(image)
        if is_recording() and img.requires_grad and out.requires_grad:
            _span_backward(img, out)
        return out

    def _run(self, image: torch.Tensor):
        """The eager call: (the image as the net takes it, [H, W] depth)."""
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
        return img, out[0, 0]

    def _graphed(self, image: torch.Tensor) -> "_Graphed":
        """The graphs of ``image``'s layout, captured on first use."""
        key = (tuple(image.shape), image.stride(), image.dtype, image.device)
        graphed = self._graphs.get(key)
        if graphed is None:
            with span("depth_net.capture"):
                graphed = self._graphs[key] = _Graphed(lambda x: self._run(x)[1], image)
        return graphed


class _Graphed:
    """The differentiable call ``body`` captured at one input layout as two
    CUDA graphs sharing a private memory pool: the forward from
    ``static_in`` to ``static_out``, and the gradient from ``static_grad_out``
    back to ``static_grad_in``. The backward graph reads the activations
    the forward graph left in the pool and, as autograd frees each after
    its use, reuses their memory: so a replay of the forward is leased
    until its one backward has run (or its output's autograd graph is
    freed), and a second call meanwhile runs eagerly."""

    WARMUP = 3      # eager calls on the capture stream first (cuDNN plans, cuBLAS handles)

    def __init__(self, body, image: torch.Tensor):
        self.busy, self._lock = False, threading.Lock()
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.device(image.device), torch.enable_grad():
            x = torch.empty_like(image).requires_grad_(True)
            with torch.no_grad():
                x.copy_(image)
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(self.WARMUP):
                    out = body(x)
                    torch.autograd.grad(out, x, torch.ones_like(out))
                del out
                pool = torch.cuda.graph_pool_handle()
                with torch.cuda.graph(self.fwd, pool=pool, stream=stream):
                    out = body(x)
                grad_out = torch.empty_like(out)
                with torch.cuda.graph(self.bwd, pool=pool, stream=stream):
                    (grad_in,) = torch.autograd.grad(out, x, grad_out)
            torch.cuda.current_stream().wait_stream(stream)
        self.static_in, self.static_out = x, out.detach()
        self.static_grad_out, self.static_grad_in = grad_out, grad_in

    def lease(self) -> Optional["_Lease"]:
        """The graphs for one call, or None while a replay awaits its backward."""
        with self._lock:
            if self.busy:
                return None
            self.busy = True
            return _Lease(self)


class _Lease:
    """One call's hold on a :class:`_Graphed`, released by its backward or
    when autograd frees the call's node (which holds the lease)."""

    def __init__(self, graphed: _Graphed):
        self.graphed, self.live = graphed, True

    def release(self) -> None:
        if self.live:
            self.live = False
            self.graphed.busy = False

    __del__ = release


REPLAY_SPAN = "depth_net.replay"


def _mark_replay() -> None:
    """Count one graph replay: an empty span opened once the launch has
    returned, so the launch's idle stays with ``depth_net.forward`` or
    ``depth_net.backward``, around it."""
    with span(REPLAY_SPAN):
        pass


class _Replay(torch.autograd.Function):
    """One graphed call: the image copied into the static input and the
    forward graph replayed; in the backward, the output's gradient copied
    in and the gradient graph replayed. The output and the image's
    gradient are copies, so no caller holds a static buffer."""

    @staticmethod
    def forward(ctx, image, lease):
        g = lease.graphed
        ctx.lease = lease
        g.static_in.copy_(image)
        g.fwd.replay()
        _mark_replay()
        return g.static_out.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        lease = ctx.lease
        if not lease.live:
            raise RuntimeError("a graphed depth-net call has one backward: the first consumed "
                               "its activations")
        g = lease.graphed
        with span("depth_net.backward"):
            g.static_grad_out.copy_(grad)
            g.bwd.replay()
            _mark_replay()
            grad_in = g.static_grad_in.clone()
        lease.release()
        return grad_in, None


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
