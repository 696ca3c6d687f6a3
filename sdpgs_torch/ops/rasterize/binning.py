"""Tile binning: a dense per-tile, depth-ordered index table.

Counterpart of ``sdpgs_tpu/ops/rasterize/binning.py``. Gaussians are
sorted by view depth once (``torch.sort(stable=True)``, as ``lax.sort``
there); then, for every tile, the depth-sorted Gaussians whose tile rect
covers it get consecutive ranks, and each kept (Gaussian, tile) entry
writes its Gaussian id to slot ``tile*K + rank`` of a [T, K] table
(sentinel P -> the zero payload row).

The table builder is kernel K2 (``csrc/binning.cu``) on CUDA tensors and
:func:`build_table_plain` on CPU tensors; the plain version mirrors the
JAX scan path (binning.py:259-303) and ``_scatter_table`` (:317-344), and
K2 stands in for all three TPU rank-kernel layouts. K2 builds the table
from coverage words (one bit per sorted Gaussian and tile, 32 Gaussians to
a word) whose popcount prefix gives each entry its rank. Capacity semantics:
per-tile K overflow and per-Gaussian D clipping are counted, never silent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdpgs_torch import _kernels
from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed


class Binning(NamedTuple):
    tile_index: torch.Tensor   # [num_tiles, K] int32 into [P+1]-padded payloads
    tile_counts: torch.Tensor  # [num_tiles] int32 entries per tile (<= K)
    overflow: torch.Tensor     # 0-d int32: entries dropped by the K cap
    clipped: torch.Tensor      # 0-d int32: tile slots dropped by the D cap
    num_entries: torch.Tensor  # 0-d int32: total (tile, gaussian) pairs


def tile_grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return -(-width // tile), -(-height // tile)


def tile_rect(mean2d, radius, tiles_x: int, tiles_y: int, tile: int):
    """Per-Gaussian tile rect (min inclusive, max exclusive), the reference's
    ``getRect`` (auxiliary.h:46-58). Returns (xmin, xmax, ymin, ymax) int32."""
    t = float(tile)

    def cell(v, hi):
        return torch.clamp(torch.floor(v / t), 0, hi).to(torch.int32)

    xmin = cell(mean2d[:, 0] - radius, tiles_x)
    ymin = cell(mean2d[:, 1] - radius, tiles_y)
    xmax = cell(mean2d[:, 0] + radius + t - 1, tiles_x)
    ymax = cell(mean2d[:, 1] + radius + t - 1, tiles_y)
    return xmin, xmax, ymin, ymax


def pack_rect(xmin, xmax, ymin, ymax):
    """Pack a tile rect into one i32, 8 bits per coord (grids up to 255
    tiles per axis); ymax may wrap into the sign bit, which
    :func:`unpack_rect` masks off."""
    return xmin | (xmax << 8) | (ymin << 16) | (ymax << 24)


def unpack_rect(packed):
    """Inverse of :func:`pack_rect` (arithmetic shift, then mask)."""
    return packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF, (packed >> 24) & 0xFF


def _tile_chunk(num_tiles: int, P: int) -> int:
    """Tiles per chunk of the plain version, so its [P, Tc] mask stays small."""
    return min(num_tiles, max(8, (1 << 24) // max(P, 1)))


def build_table_plain(packed_s, order, n_valid, num_tiles: int, tiles_x: int,
                      K: int, D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: (table [num_tiles*K] int32 with sentinel
    P, uncapped per-tile totals [num_tiles] int32). It scans all P sorted
    rects; ``n_valid`` (where the kernel stops) changes nothing here, as
    the culled ones past it have empty rects."""
    _kernels.plain_call("binning")
    P = packed_s.shape[0]
    dev = packed_s.device
    xmin, xmax, ymin, ymax = unpack_rect(packed_s)
    rect_w = xmax - xmin
    count = rect_w * (ymax - ymin)
    # per-Gaussian entry enumeration, row-major over the rect (auxiliary.h:46-58)
    d = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    rw = torch.clamp_min(rect_w, 1)[:, None]
    tid = (ymin[:, None] + d // rw) * tiles_x + xmin[:, None] + d % rw
    entry_valid = (count[:, None] > 0) & (d < count[:, None])
    tid = torch.where(entry_valid, tid, torch.full_like(tid, -1))

    rank = torch.zeros((P, D), dtype=torch.int64, device=dev)
    totals = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    Tc = _tile_chunk(num_tiles, P)
    for t0 in range(0, num_tiles, Tc):
        tiles = torch.arange(t0, min(t0 + Tc, num_tiles), dtype=torch.int32, device=dev)
        ctx, cty = tiles % tiles_x, tiles // tiles_x
        mask = ((ctx[None, :] >= xmin[:, None]) & (ctx[None, :] < xmax[:, None])
                & (cty[None, :] >= ymin[:, None]) & (cty[None, :] < ymax[:, None]))
        mi = mask.to(torch.int64)
        excl = torch.cumsum(mi, dim=0) - mi                        # [P, Tc]
        local = (tid - t0).to(torch.int64)
        inside = (local >= 0) & (local < tiles.shape[0])
        got = torch.gather(excl, 1, torch.where(inside, local, 0))
        rank = torch.where(inside, got, rank)
        totals[t0:t0 + tiles.shape[0]] = mi.sum(dim=0)

    keep = entry_valid & (rank < K)
    slot = tid.to(torch.int64) * K + rank
    table = torch.full((num_tiles * K,), P, dtype=torch.int32, device=dev)
    gid = order[:, None].expand(P, D)
    table[slot[keep]] = gid[keep]
    return table, totals.to(torch.int32)


def build_table(packed_s, order, n_valid, num_tiles: int, tiles_x: int,
                K: int, D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on CUDA tensors, its plain version on CPU tensors.

    packed_s, order: [P] int32 depth-sorted packed rects and Gaussian ids
    (valid ones first); n_valid: 0-d int32 count of valid ones. Returns
    (table [num_tiles*K] int32, sentinel P; totals [num_tiles] int32)."""
    if not packed_s.is_cuda:
        return build_table_plain(packed_s, order, n_valid, num_tiles, tiles_x, K, D)
    P = packed_s.shape[0]
    _kernels.check(packed_s, "packed_s", torch.int32, (P,))
    _kernels.check(order, "order", torch.int32, (P,))
    _kernels.check(n_valid, "n_valid", torch.int32, ())
    dev = packed_s.device
    # the kernel writes every slot of the table, sentinels included
    table = torch.empty((num_tiles * K,), dtype=torch.int32, device=dev)
    totals = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
    cover = torch.empty(num_tiles * _kernels.lib().sdpgs_bin_table_scratch_words(P),
                        dtype=torch.int32, device=dev)
    _kernels.launch(
        "binning", "sdpgs_bin_table",
        _kernels.ptr(packed_s), _kernels.ptr(order), _kernels.ptr(n_valid),
        _kernels.ptr(table), _kernels.ptr(totals), _kernels.ptr(cover), P, num_tiles, tiles_x,
        K, D, _kernels.stream(dev),
    )
    return table, totals


def sort_rects(prep: Preprocessed, width: int, height: int, cfg: RasterizeConfig):
    """Tile rects packed into one i32 per Gaussian, depth-sorted (stable;
    culled Gaussians last with empty rects). Returns (packed_s, order,
    n_valid)."""
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile)
    if tiles_x >= 256 or tiles_y >= 256:
        raise ValueError("rect packing uses 8-bit tile coords (8160 px at tile=32); "
                         "raise cfg.tile for this image size")
    xmin0, xmax0, ymin0, ymax0 = tile_rect(prep.mean2d, prep.radius, tiles_x,
                                           tiles_y, cfg.tile)
    count0 = (xmax0 - xmin0) * (ymax0 - ymin0)
    valid0 = prep.valid & (count0 > 0)                           # forward.cu:236
    xmax0 = torch.where(valid0, xmax0, xmin0)
    ymax0 = torch.where(valid0, ymax0, ymin0)
    packed = pack_rect(xmin0, xmax0, ymin0, ymax0)
    depth_key = torch.where(valid0, prep.depth, torch.full_like(prep.depth, float("inf")))
    n_valid = valid0.sum(dtype=torch.int32)
    _, order = torch.sort(depth_key, stable=True)
    return packed[order].contiguous(), order.to(torch.int32), n_valid


def bin_gaussians(prep: Preprocessed, width: int, height: int,
                  cfg: RasterizeConfig) -> Binning:
    """Depth sort, then the [T, K] table, counts and capacity telemetry."""
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile)
    num_tiles = tiles_x * tiles_y
    K = cfg.max_per_tile
    D = cfg.max_tiles_per_gaussian
    packed_s, order, n_valid = sort_rects(prep, width, height, cfg)

    xmin, xmax, ymin, ymax = unpack_rect(packed_s)
    count = (xmax - xmin) * (ymax - ymin)
    clipped = torch.clamp_min(count - D, 0).sum(dtype=torch.int32)
    num_entries = torch.clamp_max(count, D).sum(dtype=torch.int32)

    table, totals = build_table(packed_s, order, n_valid, num_tiles, tiles_x, K, D)
    return Binning(
        tile_index=table.reshape(num_tiles, K),
        tile_counts=torch.clamp_max(totals, K),
        overflow=torch.clamp_min(totals - K, 0).sum(dtype=torch.int32),
        clipped=clipped,
        num_entries=num_entries,
    )
