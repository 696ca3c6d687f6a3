"""Stable sort of f32 keys carrying an int32 payload and the gid.

Counterpart of ``sdpgs_tpu/ops/sort_pallas.py``: the drop-in for
``lax.sort((key, val1, gid), num_keys=1, is_stable=True)`` with
``gid = arange(N)`` and N a power of two in [2^14, 2^19]. Like the TPU
kernel it is wired into nothing: binning sorts with
``torch.sort(stable=True)`` (``ops/rasterize/binning.sort_rects``), as JAX
binning keeps ``lax.sort``. On CUDA tensors it runs kernel K7
(``csrc/sort.cu``, a bitonic network on the (key, gid) order), on CPU
tensors its plain version, ``torch.sort(stable=True)`` and two gathers;
both give the stable sort bit for bit.
"""

from __future__ import annotations

import torch

from sdpgs_torch import _kernels, default_device


def sort_supported(N: int) -> bool:
    """The TPU kernel's domain (sort_pallas.py:198): N a power of two in
    [2^14, 2^19]."""
    return (N & (N - 1)) == 0 and (1 << 14) <= N <= (1 << 19)


def sort_by_key_plain(key: torch.Tensor, val1: torch.Tensor, gid: torch.Tensor):
    """Plain PyTorch version of K7: (sorted keys, val1 and gid in key order)."""
    _kernels.plain_call("sort")
    ks, order = torch.sort(key, stable=True)
    return ks, val1[order], gid[order]


def sort_by_key(key: torch.Tensor, val1: torch.Tensor, gid: torch.Tensor, device=None):
    """Sort ``key`` [N] f32 stably, carrying ``val1`` [N] int32 and ``gid``
    [N] int32, which must be ``arange(N)`` (it is the tie-break). Runs on
    ``device`` (``cuda`` unless the caller asks for another), where the
    tensors must live: kernel K7 on CUDA, the plain version on the CPU.
    Returns (keys, val1, gid), each [N], in sorted order."""
    dev = default_device(device)
    if key.device.type != dev.type:
        raise ValueError(f"keys live on {key.device}, sort device is {dev}")
    N = key.shape[0]
    if not sort_supported(N):
        raise ValueError(f"sort_by_key takes N a power of two in [2^14, 2^19], got {N}")
    if not key.is_cuda:
        return sort_by_key_plain(key, val1, gid)
    for t, name, dtype in ((key, "key", torch.float32), (val1, "val1", torch.int32),
                           (gid, "gid", torch.int32)):
        _kernels.check(t, name, dtype, (N,))
    ks = torch.empty_like(key)
    vs = torch.empty_like(val1)
    gs = torch.empty_like(gid)
    _kernels.launch("sort", "sdpgs_sort_by_key", *(_kernels.ptr(t) for t in
                    (key, val1, gid, ks, vs, gs)), N, _kernels.stream(key.device))
    return ks, vs, gs
