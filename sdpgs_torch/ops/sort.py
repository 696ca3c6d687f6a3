"""Stable sort of f32 keys carrying an int32 payload and the gid.

Counterpart of ``sdpgs_tpu/ops/sort_pallas.py``: the drop-in for
``lax.sort((key, val1, gid), num_keys=1, is_stable=True)`` with
``gid = arange(N)`` and N a power of two in [2^14, 2^19]. Like the TPU
kernel it is wired into nothing: binning sorts with
``torch.sort(stable=True)`` (``ops/rasterize/binning.sort_rects``), as JAX
binning keeps ``lax.sort``. On CUDA tensors it runs kernel K7
(``csrc/sort.cu``, a least-significant-digit radix sort over
:func:`sort_bits`), on CPU tensors its plain version,
``torch.sort(stable=True)`` and two gathers; both give the stable sort bit
for bit.
"""

from __future__ import annotations

import torch

from sdpgs_torch import _kernels, default_device


def sort_supported(N: int) -> bool:
    """The TPU kernel's domain (sort_pallas.py:198): N a power of two in
    [2^14, 2^19]."""
    return (N & (N - 1)) == 0 and (1 << 14) <= N <= (1 << 19)


def sort_bits(key: torch.Tensor) -> torch.Tensor:
    """The order-preserving bits K7 sorts f32 keys by (its CUDA twin is
    ``csrc/sort.cu:sort_bits``), as int64 in [0, 2^32): -0.0 folded into
    +0.0, then every bit of a negative key flipped and the sign bit of a
    non-negative one set. Their order is IEEE ``<`` on keys that are not
    NaN, and keys that compare equal get equal bits, so a stable sort by
    them is the stable sort by key."""
    u = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


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
    out = [torch.empty_like(t) for t in (key, val1, gid)]
    tmp = [torch.empty_like(t) for t in (key, val1, gid)]   # the radix passes' ping-pong
    scratch = torch.empty(_kernels.lib().sdpgs_sort_scratch_words(N), dtype=torch.int32,
                          device=key.device)
    _kernels.launch("sort", "sdpgs_sort_by_key", *(_kernels.ptr(t) for t in
                    (key, val1, gid, *out, *tmp, scratch)), N, _kernels.stream(key.device))
    return tuple(out)
