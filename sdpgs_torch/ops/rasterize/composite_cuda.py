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
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sdpgs_torch import _kernels
from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.ops.rasterize.composite import TileOutputs, composite_tiles, tile_pixel_coords

NPAY = 13   # xy(2) conic(3) opacity*valid(1) rgb(3) depth(1) feature(3)
NCH = 7     # composited channels: rgb, depth, feature


def _check_payload(payload, num_gaussians: int) -> None:
    if payload.ndim != 2 or tuple(payload.shape) != (num_gaussians + 1, NPAY):
        raise ValueError(f"payload: expected [{num_gaussians + 1}, {NPAY}] (the zero "
                         f"sentinel row last), got {list(payload.shape)}")


def composite_gather_plain(payload, table, counts, tiles_x: int, tiles_y: int,
                           cfg: RasterizeConfig, num_gaussians: int) -> TileOutputs:
    """Plain PyTorch version of K3: gather, then composite every slot (the
    sentinel slots past ``counts`` have zero opacity and add nothing)."""
    _check_payload(payload, num_gaussians)
    _kernels.plain_call("composite")
    g = payload[table.long()]                                  # [T, K, 13]
    px, py = tile_pixel_coords(tiles_x, tiles_y, cfg.tile, device=payload.device)
    return composite_tiles(g[..., 0:2], g[..., 2:5], g[..., 5], g[..., 6:13], px, py, cfg)


def composite_vjp_plain(payload, table, counts, tiles_x: int, tiles_y: int,
                        cfg: RasterizeConfig, num_gaussians: int, g_values, g_final_t,
                        tiles_per_pass: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5: autograd's gradient of the payload
    [P+1, 13] through the gather and :func:`composite_tiles`, at cotangents
    g_values [T, tile^2, 7] and g_final_t [T, tile^2]. Tiles are
    independent, so ``tiles_per_pass`` bounds the memory autograd holds by
    differentiating that many tiles at a time."""
    _check_payload(payload, num_gaussians)
    _kernels.plain_call("composite_bwd")
    T = table.shape[0]
    step = T if tiles_per_pass is None else tiles_per_pass
    px, py = tile_pixel_coords(tiles_x, tiles_y, cfg.tile, device=payload.device)
    d_payload = torch.zeros_like(payload)
    with torch.enable_grad():
        pay = payload.detach().requires_grad_()
        for t0 in range(0, T, step):
            sl = slice(t0, min(T, t0 + step))
            g = pay[table[sl].long()]
            out = composite_tiles(g[..., 0:2], g[..., 2:5], g[..., 5], g[..., 6:13],
                                  px[sl], py[sl], cfg)
            d_payload += torch.autograd.grad((out.values, out.final_t), pay,
                                             (g_values[sl], g_final_t[sl]))[0]
    return d_payload


def _check_tiles(payload, table, counts, tiles_x: int, tiles_y: int, cfg, num_gaussians):
    T, K = table.shape
    if T != tiles_x * tiles_y:
        raise ValueError(f"table has {T} tiles, grid has {tiles_x * tiles_y}")
    if cfg.tile * cfg.tile > 1024:
        raise ValueError(f"tile {cfg.tile}: one thread per pixel needs tile^2 <= 1024")
    _check_payload(payload, num_gaussians)
    _kernels.check(payload, "payload", torch.float32, (num_gaussians + 1, NPAY))
    _kernels.check(table, "table", torch.int32, (T, K))
    if counts is not None:
        _kernels.check(counts, "counts", torch.int32, (T,))


def composite_gather_fwd(payload, table, counts, tiles_x: int, tiles_y: int,
                         cfg: RasterizeConfig, num_gaussians: int, stats=None):
    """Launch K3 on CUDA tensors autograd does not track. Returns
    (TileOutputs with n_visit, last_contrib [T, tile^2] int32: one past the
    last entry each pixel added, where K5 starts). ``stats``, a zeroed
    int64 [2] tensor, receives the (entry, pixel) pairs K3 tested and those
    that contributed, when given."""
    _check_tiles(payload, table, counts, tiles_x, tiles_y, cfg, num_gaussians)
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
        *outs, num_gaussians, T, tiles_x, cfg.tile, K, float(cfg.alpha_min),
        float(cfg.alpha_max), float(cfg.transmittance_min), _kernels.stream(dev),
    )
    return TileOutputs(values=values, final_t=final_t, n_visit=n_visit), last


def composite_gather_bwd(payload, table, final_t, last, g_values, g_final_t,
                         tiles_x: int, tiles_y: int, cfg: RasterizeConfig,
                         num_gaussians: int, stats=None) -> torch.Tensor:
    """Launch K5 on CUDA tensors autograd does not track: the payload
    gradient [P+1, 13] (row P zero) at cotangents g_values [T, tile^2, 7]
    and g_final_t [T, tile^2], from K3's final_t and last_contrib.
    ``stats``, a zeroed int64 [3] tensor, receives the contributing (entry,
    pixel) pairs, those of them clamped at ``alpha_max`` and the pairs K5
    tested, when given."""
    _check_tiles(payload, table, None, tiles_x, tiles_y, cfg, num_gaussians)
    T = table.shape[0]
    npix = cfg.tile * cfg.tile
    if npix % 32:
        raise ValueError(f"tile {cfg.tile}: K5 needs tile^2 to be a multiple of 32")
    for t, name, dtype, shape in ((final_t, "final_t", torch.float32, (T, npix)),
                                  (last, "last_contrib", torch.int32, (T, npix)),
                                  (g_values, "g_values", torch.float32, (T, npix, NCH)),
                                  (g_final_t, "g_final_t", torch.float32, (T, npix))):
        _kernels.check(t, name, dtype, shape)
    if stats is not None:
        _kernels.check(stats, "stats", torch.int64, (3,))
    d_payload = torch.zeros_like(payload)
    _kernels.launch(
        "composite_bwd", "sdpgs_composite_bwd",
        _kernels.ptr(payload), _kernels.ptr(table), _kernels.ptr(final_t),
        _kernels.ptr(last), _kernels.ptr(g_values), _kernels.ptr(g_final_t),
        _kernels.ptr(d_payload), _kernels.ptr(stats), num_gaussians, T, tiles_x, cfg.tile,
        table.shape[1], float(cfg.alpha_min), float(cfg.alpha_max),
        _kernels.stream(payload.device),
    )
    return d_payload


class _CompositeGather(torch.autograd.Function):
    """K3 forward, K5 backward; the launchers get detached tensors."""

    @staticmethod
    def forward(ctx, payload, table, counts, tiles_x, tiles_y, cfg, num_gaussians):
        payload = payload.detach()
        out, last = composite_gather_fwd(payload, table, counts, tiles_x, tiles_y, cfg,
                                         num_gaussians)
        ctx.save_for_backward(payload, table, out.final_t, last)
        ctx.args = (tiles_x, tiles_y, cfg, num_gaussians)
        ctx.mark_non_differentiable(out.n_visit)
        return out.values, out.final_t, out.n_visit

    @staticmethod
    @once_differentiable
    def backward(ctx, g_values, g_final_t, _g_visit):
        # final_t was saved as an output of this Function, so it comes back
        # tracked by autograd: hand the launcher a detached view (no copy)
        payload, table, final_t, last = (t.detach() for t in ctx.saved_tensors)
        d_payload = composite_gather_bwd(payload, table, final_t, last,
                                         g_values.contiguous(), g_final_t.contiguous(),
                                         *ctx.args)
        return d_payload, None, None, None, None, None, None


def composite_gather(payload, table, counts, tiles_x: int, tiles_y: int,
                     cfg: RasterizeConfig, num_gaussians: int) -> TileOutputs:
    """K3 (backward K5) on CUDA tensors, the plain version on CPU tensors.

    payload [P+1, 13] f32 with P = ``num_gaussians`` (row P is the zero
    sentinel), table [T, K] int32 with entries in [0, P], counts [T] int32
    (<= K). Returns TileOutputs with values [T, tile^2, 7] and final_t
    [T, tile^2], differentiable with respect to the payload; the kernel
    also fills n_visit."""
    if not payload.is_cuda:
        return composite_gather_plain(payload, table, counts, tiles_x, tiles_y, cfg,
                                      num_gaussians)
    values, final_t, n_visit = _CompositeGather.apply(payload, table, counts, tiles_x,
                                                      tiles_y, cfg, num_gaussians)
    return TileOutputs(values=values, final_t=final_t, n_visit=n_visit)
