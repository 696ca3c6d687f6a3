"""k-nearest neighbours by chunked brute force.

Counterpart of ``sdpgs_tpu/ops/knn.py`` (the reference's
``simple_knn._C.distCUDA2``, read for the init scales and for proximity
densification, gaussian_model.py:198-201, 514-518). Per query chunk the
squared distances ``|q|^2 - 2 q.p + |p|^2`` come from one ``torch.matmul``
(as JAX leaves the product to XLA, outside any Pallas kernel) and norms
rounded as XLA rounds them; self and dead points get +inf; the k
smallest are taken.

``lax.top_k`` returns the lower index first among equal values, and
``torch.topk`` promises no order on ties (duplicated points tie exactly).
So the selection sorts on one int64 key per candidate, the distance's
order-preserving bits above the index, which makes the (distance, index)
order explicit and equal to JAX's.

That chain is the plain version (``knn_plain``), which CPU tensors take. On
CUDA tensors one launch of ``knn_kernel`` (``csrc/knn.cu``) computes the
same distances in the same rounding and keeps each row's k best keys in
registers, with no [chunk, N] block in memory; the two agree bit for bit.
"""

from __future__ import annotations

import torch

from sdpgs_torch import _kernels, default_device

MAX_K = 8    # kMaxK of csrc/knn.cu: the largest k the kernel takes


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """[N] |p|^2 as XLA's fused reduce forms it, a chain of fused
    multiply-adds fma(z, z, fma(y, y, x x)), each rounded once to f32 (the
    products are exact in f64). |q|^2 - 2 q.p + |p|^2 cancels to ~1e-6 of
    |p|^2, so the norm's last bit moves near neighbours' distances."""
    p64 = p.double()
    s = p[:, 0] * p[:, 0]
    s = (p64[:, 1] * p64[:, 1] + s.double()).float()
    return (p64[:, 2] * p64[:, 2] + s.double()).float()


def _ordered_bits(d2: torch.Tensor) -> torch.Tensor:
    """int64 keys that order like the f32 values (-0.0 folded into +0.0,
    as IEEE comparison treats them)."""
    b = (d2 + 0.0).view(torch.int32)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return b.to(torch.int64)


def knn(points: torch.Tensor, k: int = 3, mask: torch.Tensor | None = None,
        chunk: int = 1024, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """For each point, the k nearest *other* points.

    points [N, 3] f32; mask: optional [N] float/bool validity (invalid
    points are never neighbours and their distances are +inf); chunk: the
    plain version's query rows per matmul (the kernel takes none). Runs on
    ``device`` (``cuda`` unless the caller asks for another), where the
    tensors must live: the kernel on CUDA (k at most ``MAX_K``), the plain
    version on the CPU. Returns (squared distances [N, k] f32, clamped at
    0, and indices [N, k] int64), by ascending distance, ties by ascending
    index."""
    dev = default_device(device)
    if points.device.type != dev.type:
        raise ValueError(f"points live on {points.device}, k-NN device is {dev}")
    if points.is_cuda:
        return knn_cuda(points, k, mask)
    return knn_plain(points, k, mask, chunk)


@torch.no_grad()
def knn_cuda(points: torch.Tensor, k: int = 3, mask: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``knn_kernel``: ``knn`` on CUDA tensors."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the k-NN kernel takes k from 1 to {MAX_K}, got {k}")
    n = points.shape[0]
    if n < k:
        raise ValueError(f"k-NN of {n} points with k = {k}")
    points = points.detach().to(torch.float32).contiguous()
    _kernels.check(points, "points", torch.float32, (n, 3))
    sq_norm = _sq_norm(points)
    invalid = None
    if mask is not None:
        invalid = (mask.detach().to(torch.float32) == 0.0).contiguous()
        _kernels.check(invalid, "mask", torch.bool, (n,))
    d2 = torch.empty((n, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=points.device)
    _kernels.launch("knn", "sdpgs_knn", *(_kernels.ptr(t) for t in (points, sq_norm, invalid)),
                    n, k, _kernels.ptr(d2), _kernels.ptr(idx), _kernels.stream(points.device))
    return d2, idx


def knn_plain(points: torch.Tensor, k: int = 3, mask: torch.Tensor | None = None,
              chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``knn``, by query chunks of ``chunk`` rows."""
    _kernels.plain_call("knn")
    n = points.shape[0]
    points = points.to(torch.float32)
    sq_norm = _sq_norm(points)
    invalid = None if mask is None else (mask.to(torch.float32) == 0.0)
    cols = torch.arange(n, device=points.device)
    d2s, idxs = [], []
    for s in range(0, n, chunk):
        q = points[s:s + chunk]
        d2 = sq_norm[s:s + chunk, None] - 2.0 * (q @ points.T) + sq_norm[None, :]
        drop = cols[None, :] == torch.arange(s, s + q.shape[0], device=points.device)[:, None]
        if invalid is not None:
            drop = drop | invalid[None, :]
        d2 = torch.where(drop, torch.inf, d2)
        key = (_ordered_bits(d2) << 32) | cols[None, :]
        sel = torch.topk(key, k, dim=-1, largest=False, sorted=True).values & 0xFFFFFFFF
        d2s.append(torch.gather(d2, 1, sel))
        idxs.append(sel)
    return torch.clamp_min(torch.cat(d2s), 0.0), torch.cat(idxs)


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3, mask: torch.Tensor | None = None,
                        device=None) -> torch.Tensor:
    """``distCUDA2``: the mean squared distance to the k nearest neighbours
    over the finite ones, clamped from below at 1e-7 (reference
    gaussian_model.py:198)."""
    d2, _ = knn(points, k=k, mask=mask, device=device)
    finite = torch.isfinite(d2)
    d2 = torch.where(finite, d2, 0.0)
    cnt = torch.clamp_min(finite.sum(-1), 1)
    return torch.clamp_min(d2.sum(-1) / cnt, 1e-7)
