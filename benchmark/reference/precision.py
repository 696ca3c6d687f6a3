"""The precisions the reference runs in.

``stated()``: the configurations' own, float32 with TF32 off (the depth
net computes in bfloat16 by its configuration). ``Lower()``: the control,
one step below: every matrix product and convolution rounds its float32
operands to TF32 (10 mantissa bits, round to nearest even, as the tensor
cores take them) and its bfloat16 operands to float8 e4m3 with a scale
per tensor, and accumulates as before. It is a dispatch mode, so it
reaches the backward's products too, on the card and on the CPU alike.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
F8_MAX = 448.0
# op -> positions of the operands that are rounded
PRODUCTS = {
    aten.mm.default: (0, 1),
    aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2),
    aten.convolution.default: (0, 1),
    aten.convolution_backward.default: (0, 1, 2),
}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return r.view(torch.float32).view(x.shape)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = F8_MAX / x.detach().abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def lower(x):
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.float32:
        return to_tf32(x)
    if x.dtype == torch.bfloat16:
        return to_fp8(x)
    return x


class Lower(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        where = PRODUCTS.get(func)
        if where is not None:
            args = tuple(lower(a) if i in where else a for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def stated():
    """TF32 off for the duration, whatever the process had set."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def context(control: bool):
    """The reference's precision, or the control's one step below it."""
    stack = contextlib.ExitStack()
    stack.enter_context(stated())
    if control:
        stack.enter_context(Lower())
    return stack
