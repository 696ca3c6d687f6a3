"""Tile compositing with the payload gather fused in: kernels K3
(``csrc/composite.cu``, forward) and K5 (``csrc/composite_bwd.cu``,
backward) and their plain versions.

Counterpart of ``sdpgs_tpu/ops/rasterize/composite_pallas.py``. The
kernels read each tile's table row and gather the packed [P+1, 13]
payload themselves; K5 returns the gradient of that payload. The plain
version gathers [T, K, 13] and runs ``composite.composite_tiles``, and
autograd differentiates it. On CUDA tensors :func:`composite_gather` is an
``autograd.Function`` (K3 forward, K5 backward); on CPU tensors autograd
runs through the plain version.

A table of T rows holds the tiles from flat tile ``t0`` of the grid (0 and
every tile for a whole view; a tile-sharded render passes its range): pixel
coordinates come from the global tile, and a row past the grid, which
binning leaves empty, composites nothing (values 0, final_t 1).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sdpgs_torch import _kernels
from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.ops.rasterize.composite import (
    TileOutputs,
    composite_tiles,
    tile_pixel_coords_range,
)

NPAY = 13   # xy(2) conic(3) opacity*valid(1) rgb(3) depth(1) feature(3)
NCH = 7     # composited channels: rgb, depth, feature
SQUARE = 16  # composite_math.cuh kSquare: a block's side where it divides the tile


def _check_payload(payload, num_gaussians: int) -> None:
    if payload.ndim != 2 or tuple(payload.shape) != (num_gaussians + 1, NPAY):
        raise ValueError(f"payload: expected [{num_gaussians + 1}, {NPAY}] (the zero "
                         f"sentinel row last), got {list(payload.shape)}")


def _grid_rows(table, tiles_x: int, tiles_y: int, t0: int, num_gaussians: int):
    """The table as K3 and K5 read it: rows past the grid hold the sentinel."""
    T = table.shape[0]
    past = min(T, max(0, t0 + T - tiles_x * tiles_y))
    if past:
        table = table.clone()
        table[T - past:] = num_gaussians
    return table


def composite_gather_plain(payload, table, counts, tiles_x: int, tiles_y: int,
                           cfg: RasterizeConfig, num_gaussians: int,
                           t0: int = 0) -> TileOutputs:
    """Plain PyTorch version of K3: gather, then composite every slot (the
    sentinel slots past ``counts`` have zero opacity and add nothing)."""
    _check_payload(payload, num_gaussians)
    _kernels.plain_call("composite")
    table = _grid_rows(table, tiles_x, tiles_y, t0, num_gaussians)
    g = payload[table.long()]                                  # [T, K, 13]
    px, py = tile_pixel_coords_range(t0, table.shape[0], tiles_x, cfg.tile,
                                     device=payload.device)
    return composite_tiles(g[..., 0:2], g[..., 2:5], g[..., 5], g[..., 6:13], px, py, cfg)


def composite_vjp_plain(payload, table, counts, tiles_x: int, tiles_y: int,
                        cfg: RasterizeConfig, num_gaussians: int, g_values, g_final_t,
                        tiles_per_pass: int | None = None, t0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K5: autograd's gradient of the payload
    [P+1, 13] through the gather and :func:`composite_tiles`, at cotangents
    g_values [T, tile^2, 7] and g_final_t [T, tile^2]. Tiles are
    independent, so ``tiles_per_pass`` bounds the memory autograd holds by
    differentiating that many tiles at a time."""
    _check_payload(payload, num_gaussians)
    _kernels.plain_call("composite_bwd")
    table = _grid_rows(table, tiles_x, tiles_y, t0, num_gaussians)
    T = table.shape[0]
    step = T if tiles_per_pass is None else tiles_per_pass
    px, py = tile_pixel_coords_range(t0, T, tiles_x, cfg.tile, device=payload.device)
    d_payload = torch.zeros_like(payload)
    with torch.enable_grad():
        pay = payload.detach().requires_grad_()
        for r0 in range(0, T, step):
            sl = slice(r0, min(T, r0 + step))
            g = pay[table[sl].long()]
            out = composite_tiles(g[..., 0:2], g[..., 2:5], g[..., 5], g[..., 6:13],
                                  px[sl], py[sl], cfg)
            d_payload += torch.autograd.grad((out.values, out.final_t), pay,
                                             (g_values[sl], g_final_t[sl]))[0]
    return d_payload


def _check_tiles(payload, table, counts, tiles_x: int, tiles_y: int, cfg, num_gaussians,
                 t0: int):
    T, K = table.shape
    if t0 < 0 or T > tiles_x * tiles_y:
        raise ValueError(f"table of {T} tiles from tile {t0}: a range of the grid's "
                         f"{tiles_x * tiles_y} tiles needs t0 >= 0 and at most that many rows")
    if cfg.tile * cfg.tile > 1024:
        raise ValueError(f"tile {cfg.tile}: one thread per pixel needs tile^2 <= 1024")
    _check_payload(payload, num_gaussians)
    _kernels.check(payload, "payload", torch.float32, (num_gaussians + 1, NPAY))
    _kernels.check(table, "table", torch.int32, (T, K))
    if counts is not None:
        _kernels.check(counts, "counts", torch.int32, (T,))


def composite_gather_fwd(payload, table, counts, tiles_x: int, tiles_y: int,
                         cfg: RasterizeConfig, num_gaussians: int, stats=None, t0: int = 0):
    """Launch K3 on CUDA tensors autograd does not track. Returns
    (TileOutputs with n_visit, last_contrib [T, tile^2] int32: one past the
    last entry each pixel added, where K5 starts). ``stats``, a zeroed
    int64 [2] tensor, receives the (entry, pixel) pairs K3 tested and those
    that contributed, when given. The T rows are the tiles from ``t0``."""
    _check_tiles(payload, table, counts, tiles_x, tiles_y, cfg, num_gaussians, t0)
    T, K = table.shape
    npix = cfg.tile * cfg.tile
    dev = payload.device
    values = torch.empty((T, npix, NCH), dtype=torch.float32, device=dev)
    final_t = torch.empty((T, npix), dtype=torch.float32, device=dev)
    n_visit = torch.empty((T, npix), dtype=torch.int32, device=dev)
    last = torch.empty((T, npix), dtype=torch.int32, device=dev)
    outs = [_kernels.ptr(t) for t in (values, final_t, n_visit, last)]
    if stats is None:
        fn = "sdpgs_composite_fwd"
    else:
        _kernels.check(stats, "stats", torch.int64, (2,))
        fn = "sdpgs_composite_fwd_stats"
        outs.append(_kernels.ptr(stats))
    _kernels.launch(
        "composite", fn, _kernels.ptr(payload), _kernels.ptr(table), _kernels.ptr(counts),
        *outs, num_gaussians, T, t0, tiles_x * tiles_y, tiles_x, cfg.tile, K,
        float(cfg.alpha_min),
        float(cfg.alpha_max), float(cfg.transmittance_min), _kernels.stream(dev),
    )
    return TileOutputs(values=values, final_t=final_t, n_visit=n_visit), last


def squares(tile: int) -> int:
    """K3's and K5's blocks per tile: its SQUARE x SQUARE squares, or the
    whole tile where SQUARE does not divide it (square_side)."""
    side = SQUARE if tile % SQUARE == 0 else tile
    return (tile // side) ** 2


def composite_bwd_scratch(T: int, K: int, tile: int, num_gaussians: int, D: int, dev):
    """K5's scratch, uninitialised, in one allocation: the entry map [P, D]
    i32, the blocks' starts [T * squares] i32 and their partials
    [T * squares, K, 13] f32."""
    rows = T * squares(tile)
    n_map = num_gaussians * D
    buf = torch.empty((n_map + rows + rows * K * NPAY,), dtype=torch.int32, device=dev)
    return (buf[:n_map].view(num_gaussians, D), buf[n_map + rows:].view(torch.float32)
            .view(rows, K, NPAY), buf[n_map:n_map + rows])


def composite_gather_bwd(payload, table, rects, final_t, last, g_values, g_final_t,
                         tiles_x: int, tiles_y: int, cfg: RasterizeConfig,
                         num_gaussians: int, stats=None, t0: int = 0) -> torch.Tensor:
    """Launch K5 on CUDA tensors autograd does not track: the payload
    gradient [P+1, 13] (row P zero) at cotangents g_values [T, tile^2, 7]
    and g_final_t [T, tile^2], from K3's final_t and last_contrib. ``rects``
    [P] int32 are the packed tile rects binning listed the Gaussians by
    (``Binning.rects``): K5 sums each Gaussian's entries in the order of
    its rect's tiles, so the result is the same bit for bit on every
    launch. ``stats``, a zeroed int64 [3] tensor, receives the contributing
    (entry, pixel) pairs, those of them clamped at ``alpha_max`` and the
    pairs K5 tested, when given. The T rows are the tiles from ``t0``."""
    _check_tiles(payload, table, None, tiles_x, tiles_y, cfg, num_gaussians, t0)
    T, K = table.shape
    D = cfg.max_tiles_per_gaussian
    npix = cfg.tile * cfg.tile
    if npix % 32:
        raise ValueError(f"tile {cfg.tile}: K5 needs tile^2 to be a multiple of 32")
    for t, name, dtype, shape in ((rects, "rects", torch.int32, (num_gaussians,)),
                                  (final_t, "final_t", torch.float32, (T, npix)),
                                  (last, "last_contrib", torch.int32, (T, npix)),
                                  (g_values, "g_values", torch.float32, (T, npix, NCH)),
                                  (g_final_t, "g_final_t", torch.float32, (T, npix))):
        _kernels.check(t, name, dtype, shape)
    if stats is not None:
        _kernels.check(stats, "stats", torch.int64, (3,))
    # the kernel writes every row, the sentinel's zeros included
    d_payload = torch.empty_like(payload)
    entry_map, partial, tops = composite_bwd_scratch(T, K, cfg.tile, num_gaussians, D,
                                                     payload.device)
    _kernels.launch(
        "composite_bwd", "sdpgs_composite_bwd",
        _kernels.ptr(payload), _kernels.ptr(table), _kernels.ptr(rects), _kernels.ptr(final_t),
        _kernels.ptr(last), _kernels.ptr(g_values), _kernels.ptr(g_final_t),
        _kernels.ptr(d_payload), _kernels.ptr(stats), _kernels.ptr(entry_map),
        _kernels.ptr(partial), _kernels.ptr(tops), num_gaussians, T, t0, tiles_x * tiles_y,
        tiles_x, cfg.tile, K, D, float(cfg.alpha_min), float(cfg.alpha_max),
        _kernels.stream(payload.device),
    )
    return d_payload


class _CompositeGather(torch.autograd.Function):
    """K3 forward, K5 backward; the launchers get detached tensors."""

    @staticmethod
    def forward(ctx, payload, table, counts, rects, tiles_x, tiles_y, cfg, num_gaussians, t0):
        payload = payload.detach()
        out, last = composite_gather_fwd(payload, table, counts, tiles_x, tiles_y, cfg,
                                         num_gaussians, t0=t0)
        ctx.save_for_backward(payload, table, rects, out.final_t, last)
        ctx.args = (tiles_x, tiles_y, cfg, num_gaussians)
        ctx.t0 = t0
        ctx.mark_non_differentiable(out.n_visit)
        return out.values, out.final_t, out.n_visit

    @staticmethod
    @once_differentiable
    def backward(ctx, g_values, g_final_t, _g_visit):
        # final_t was saved as an output of this Function, so it comes back
        # tracked by autograd: hand the launcher a detached view (no copy)
        payload, table, rects, final_t, last = (t.detach() for t in ctx.saved_tensors)
        d_payload = composite_gather_bwd(payload, table, rects, final_t, last,
                                         g_values.contiguous(), g_final_t.contiguous(),
                                         *ctx.args, t0=ctx.t0)
        return d_payload, None, None, None, None, None, None, None, None


def composite_gather(payload, table, counts, tiles_x: int, tiles_y: int,
                     cfg: RasterizeConfig, num_gaussians: int, t0: int = 0, *,
                     rects) -> TileOutputs:
    """K3 (backward K5) on CUDA tensors, the plain version on CPU tensors.

    payload [P+1, 13] f32 with P = ``num_gaussians`` (row P is the zero
    sentinel), table [T, K] int32 with entries in [0, P] for the T tiles
    from flat tile ``t0``, counts [T] int32 (<= K), rects [P] int32 the
    packed tile rects the table was binned from (``Binning.rects``: K5
    sums each Gaussian's entries in their order).
    Returns TileOutputs with values [T, tile^2, 7] and final_t [T, tile^2],
    differentiable with respect to the payload; the kernel also fills
    n_visit."""
    if not payload.is_cuda:
        return composite_gather_plain(payload, table, counts, tiles_x, tiles_y, cfg,
                                      num_gaussians, t0=t0)
    values, final_t, n_visit = _CompositeGather.apply(payload, table, counts, rects, tiles_x,
                                                      tiles_y, cfg, num_gaussians, t0)
    return TileOutputs(values=values, final_t=final_t, n_visit=n_visit)
