"""Tile compositing with the payload gather fused in: kernel K3
(``csrc/composite.cu``) and its plain version.

Counterpart of ``sdpgs_tpu/ops/rasterize/composite_pallas.py`` (forward
only; the backward kernel comes with the training slice). The kernel reads
each tile's table row and gathers the packed [P+1, 13] payload itself; the
plain version gathers [T, K, 13] and runs ``composite.composite_tiles``.
"""

from __future__ import annotations

import torch

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


def composite_gather(payload, table, counts, tiles_x: int, tiles_y: int,
                     cfg: RasterizeConfig, num_gaussians: int) -> TileOutputs:
    """Kernel K3 on CUDA tensors, its plain version on CPU tensors.

    payload [P+1, 13] f32 with P = ``num_gaussians`` (row P is the zero
    sentinel), table [T, K] int32 with entries in [0, P], counts [T] int32
    (<= K). Returns TileOutputs with values [T, tile^2, 7] and final_t
    [T, tile^2]; the kernel also fills n_visit."""
    if not payload.is_cuda:
        return composite_gather_plain(payload, table, counts, tiles_x, tiles_y, cfg,
                                      num_gaussians)
    _check_payload(payload, num_gaussians)
    T, K = table.shape
    npix = cfg.tile * cfg.tile
    if T != tiles_x * tiles_y:
        raise ValueError(f"table has {T} tiles, grid has {tiles_x * tiles_y}")
    if npix > 1024:
        raise ValueError(f"tile {cfg.tile}: one thread per pixel needs tile^2 <= 1024")
    _kernels.check(payload, "payload", torch.float32, (num_gaussians + 1, NPAY))
    _kernels.check(table, "table", torch.int32, (T, K))
    _kernels.check(counts, "counts", torch.int32, (T,))
    dev = payload.device
    values = torch.empty((T, npix, NCH), dtype=torch.float32, device=dev)
    final_t = torch.empty((T, npix), dtype=torch.float32, device=dev)
    n_visit = torch.empty((T, npix), dtype=torch.int32, device=dev)
    _kernels.launch(
        "composite", "sdpgs_composite_fwd",
        _kernels.ptr(payload), _kernels.ptr(table), _kernels.ptr(counts),
        _kernels.ptr(values), _kernels.ptr(final_t), _kernels.ptr(n_visit),
        num_gaussians, T, tiles_x, cfg.tile, K, float(cfg.alpha_min), float(cfg.alpha_max),
        float(cfg.transmittance_min), _kernels.stream(dev),
    )
    return TileOutputs(values=values, final_t=final_t, n_visit=n_visit)
