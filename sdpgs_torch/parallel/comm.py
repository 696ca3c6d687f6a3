"""The collectives of the sharded step.

JAX inserts these itself: GSPMD around the sharded parameters and moments,
and ``shard_map``'s transpose, which sums the cotangents of a tile shard's
replicated inputs over the tile axis (``sdpgs_tpu/parallel/tile_shard.py``).
The port calls them explicitly, each composed from ``all_reduce`` alone:
gloo on CUDA tensors offers only ``all_reduce`` and ``broadcast``, and the
same code then runs on gloo on the CPU, gloo ranks sharing one card, and
NCCL. A gather is the sum of zero-filled buffers, each rank writing its own
rows, which is exact: adding zeros changes nothing but the sign of -0.
Every function is a no-op on a group of ``None`` (an axis of size 1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group, in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``local`` (one shape on all) along dim 0, in
    rank order."""
    n = _size(group)
    if n == 1:
        return local
    m = local.shape[0]
    full = local.new_zeros((n * m,) + tuple(local.shape[1:]))
    i = _index(group)
    full[i * m:(i + 1) * m] = local
    return all_sum(full, group)


class _GatherTiles(torch.autograd.Function):
    """Gather of tile shards; its backward hands each rank its own rows of
    the cotangent, which is the same on every rank of the tile axis (each
    computes the same loss from the gathered image)."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.rows = local.shape[0]
        ctx.index = _index(group)
        return gather_rows(local.detach(), group)

    @staticmethod
    def backward(ctx, grad):
        i, m = ctx.index, ctx.rows
        return grad[i * m:(i + 1) * m], None


def gather_tiles(local: torch.Tensor, group) -> torch.Tensor:
    """Differentiable gather over the tile axis (see ``_GatherTiles``)."""
    if group is None:
        return local
    return _GatherTiles.apply(local, group)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group: the
    counterpart of the psum ``shard_map``'s transpose puts on a tile
    shard's replicated inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_sum(grad.contiguous().clone(), ctx.group), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _SumGrad.apply(x, group)


def slot_range(capacity: int, group) -> tuple[int, int]:
    """This rank's slots of the Gaussian axis under ZeRO: the contiguous
    ``capacity / n`` rows at its index on the axis."""
    n = _size(group)
    if capacity % n:
        raise ValueError(f"capacity {capacity} is not a multiple of the gauss axis {n}")
    per = capacity // n
    i = _index(group)
    return i * per, (i + 1) * per
