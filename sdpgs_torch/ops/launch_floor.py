"""The launch-floor probe: ``out = packed + gid + tid[:, 0]``.

Counterpart of ``scripts/perf_rank_variants.py:make_overhead_call`` (row C
of that script): a near-empty kernel over the binning kernel's grid, whose
time is the floor under every kernel time of the port. On CUDA tensors it
runs kernel K8 (``csrc/launch_floor.cu``, one thread per slot over P/256
blocks of 256), on CPU tensors its plain version.
"""

from __future__ import annotations

import torch

from sdpgs_torch import _kernels, default_device


def launch_floor_plain(packed: torch.Tensor, gid: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8 (int32 adds wrap, as on the card)."""
    _kernels.plain_call("launch_floor")
    return packed + gid + tid[:, 0]


def launch_floor(packed: torch.Tensor, gid: torch.Tensor, tid: torch.Tensor,
                 device=None) -> torch.Tensor:
    """``packed`` [P] int32, ``gid`` [P] int32, ``tid`` [P, D] int32 ->
    [P] int32 on ``device`` (``cuda`` unless the caller asks for another),
    where the tensors must live: kernel K8 on CUDA, the plain version on
    the CPU."""
    dev = default_device(device)
    if packed.device.type != dev.type:
        raise ValueError(f"inputs live on {packed.device}, probe device is {dev}")
    if not packed.is_cuda:
        return launch_floor_plain(packed, gid, tid)
    P, D = tid.shape
    _kernels.check(packed, "packed", torch.int32, (P,))
    _kernels.check(gid, "gid", torch.int32, (P,))
    _kernels.check(tid, "tid", torch.int32, (P, D))
    out = torch.empty_like(packed)
    _kernels.launch("launch_floor", "sdpgs_launch_floor", _kernels.ptr(packed), _kernels.ptr(gid),
                    _kernels.ptr(tid), _kernels.ptr(out), P, D, _kernels.stream(packed.device))
    return out
