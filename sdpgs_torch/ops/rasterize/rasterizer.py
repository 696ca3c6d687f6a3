"""Rasterizer API: preprocess -> bin -> gather + composite -> image.

Counterpart of ``sdpgs_tpu/ops/rasterize/rasterizer.py``: the extended
outputs the framework consumes (reference gaussian_renderer/__init__.py:
315-326): color, expected depth, alpha, 3-channel feature image, radii,
plus capacity telemetry. ``rasterize`` is differentiable: gradients flow
through the payload rows (``payload.py``; K3/K5 on CUDA); binning consumes
the detached screen record.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from sdpgs_torch import default_device
from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.ops.rasterize import binning as binning_lib
from sdpgs_torch.ops.rasterize.composite import (
    TileOutputs,
    assemble_image,
    composite_tiles,
)
from sdpgs_torch.ops.rasterize.composite_cuda import composite_gather
from sdpgs_torch.ops.rasterize.payload import Payload, make_payload, pad_row, screen_of
from sdpgs_torch.ops.rasterize.preprocess import preprocess


class RenderOutput(NamedTuple):
    color: torch.Tensor       # [H, W, 3]
    depth: torch.Tensor       # [H, W] expected depth (sum w_i * z_i)
    alpha: torch.Tensor       # [H, W] 1 - final transmittance
    feature: torch.Tensor     # [H, W, 3] composited language feature
    radii: torch.Tensor       # [P] screen radii (0 for invisible)
    visibility: torch.Tensor  # [P] bool, radii > 0
    overflow: torch.Tensor    # telemetry: entries dropped by per-tile cap K
    clipped: torch.Tensor     # telemetry: tile slots dropped by per-Gaussian cap D
    tile_counts: torch.Tensor  # [T] int32 entries listed per tile: K3's and K5's work
    tile_totals: torch.Tensor  # [T] int32 entries per tile before the K cap


def _check_device(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t is not None and t.device.type != device.type:
            raise ValueError(f"input on {t.device}, render device is {device}")


def render_output(vals, final_t, bg, radius, overflow, clipped, tile_counts,
                  tile_totals) -> RenderOutput:
    """The outputs of one view from its composited ``vals`` [H, W, 7] (rgb,
    expected depth, feature), final transmittance ``final_t`` [H, W] and
    background ``bg`` [3], the preprocess's radii and the binning telemetry."""
    bg = torch.as_tensor(bg, dtype=torch.float32, device=vals.device)
    radii = radius.detach()
    return RenderOutput(
        color=vals[..., :3] + final_t[..., None] * bg[None, None, :],
        depth=vals[..., 3],
        alpha=1.0 - final_t,
        feature=vals[..., 4:7],
        radii=radii,
        visibility=radii > 0.0,
        overflow=overflow,
        clipped=clipped,
        tile_counts=tile_counts,
        tile_totals=tile_totals,
    )


def plain_payload(xyz, cov3d, opacity, color, feature, alive, cam: Camera,
                  cfg: RasterizeConfig, means2d_offset=None, feature_weight=None) -> Payload:
    """The payload of the plain preprocess from a world covariance ``cov3d``
    [P, 3, 3] (the JAX package's XLA path; ``render`` takes K1's instead)."""
    prep = preprocess(xyz, cov3d, cam, alive, near=cfg.near, low_pass=cfg.low_pass)
    if means2d_offset is not None:
        prep = prep._replace(mean2d=prep.mean2d + means2d_offset)
    if feature_weight is not None:
        feature = feature * feature_weight[:, None]
    return Payload(make_payload(prep, opacity, color, feature), screen_of(prep))


def rasterize_tiles(
    payload: Payload, cam: Camera, cfg: RasterizeConfig,
    tile_range: Optional[tuple[int, int]] = None,
    payload_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[TileOutputs, binning_lib.Binning]:
    """Bin -> gather + composite one view's ``payload`` for every tile, or
    with ``tile_range=(t0, n_local)`` for the ``n_local`` tiles from flat
    tile ``t0`` (a tile-sharded render's shard; JAX rasterizer.py:95-200).
    ``payload_grad`` wraps the [P+1, 13] rows before the compositing: the
    tile-sharded render passes the sum of their gradient over the tile axis
    there."""
    bins = binning_lib.bin_gaussians(payload.screen, cam.width, cam.height, cfg,
                                     tile_range=tile_range)
    rows = payload.rows
    if payload_grad is not None:
        rows = payload_grad(rows)
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    out = composite_gather(rows, bins.tile_index, bins.tile_counts, tiles_x, tiles_y, cfg,
                           rows.shape[0] - 1, t0=0 if tile_range is None else tile_range[0],
                           rects=bins.rects)
    return out, bins


def rasterize(
    xyz: Optional[torch.Tensor],    # [P, 3]
    cov3d: Optional[torch.Tensor],  # [P, 3, 3] world covariance
    opacity: Optional[torch.Tensor],  # [P] activated opacity (dead slots zero)
    color: Optional[torch.Tensor],  # [P, 3] per-Gaussian RGB
    feature: Optional[torch.Tensor],  # [P, 3] per-Gaussian language feature
    alive: Optional[torch.Tensor],  # [P] float mask
    cam: Camera,
    bg,                             # [3]
    cfg: RasterizeConfig,
    means2d_offset=None,
    feature_weight=None,
    device=None,
    *,
    payload: Optional[Payload] = None,
) -> RenderOutput:
    """Differentiable render of one view on ``device`` (``cuda`` unless the
    caller asks for another); the inputs must already live there.
    ``payload`` (``preprocess_cuda.preprocess_payload``'s, as ``render``
    passes it) takes the place of the plain preprocess from ``cov3d``, and
    the per-Gaussian arguments are then not read; ``feature_weight`` scales
    the feature channels per Gaussian (the reference's ``confidence``).
    ``means2d_offset`` [P, 2] (zeros) is added to the screen centres: its
    gradient is the per-Gaussian screen-space gradient the densification
    statistics read (reference gaussian_renderer/__init__.py:217-221)."""
    dev = default_device(device)
    cam = cam.to(dev)
    if payload is None:
        _check_device(dev, xyz, opacity, color, feature, alive)
        payload = plain_payload(xyz, cov3d, opacity, color, feature, alive, cam, cfg,
                                means2d_offset=means2d_offset, feature_weight=feature_weight)
    else:
        _check_device(dev, payload.rows)
    out, bins = rasterize_tiles(payload, cam, cfg)
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    H, W = cam.height, cam.width
    vals = assemble_image(out.values, tiles_x, tiles_y, cfg.tile, H, W)
    final_t = assemble_image(out.final_t[..., None], tiles_x, tiles_y, cfg.tile, H, W)[..., 0]
    return render_output(vals, final_t, bg, payload.screen.radius, bins.overflow,
                         bins.clipped, bins.tile_counts, bins.tile_totals)


@torch.no_grad()
def rasterize_naive(xyz, cov3d, opacity, color, feature, alive, cam: Camera, bg,
                    cfg: RasterizeConfig, device=None) -> RenderOutput:
    """Slow-but-obviously-correct golden renderer: every Gaussian against
    every pixel, no tiling and no per-tile capacity, with the binned path's
    tile-rect cutoff so the two agree. Used to validate ``rasterize``."""
    dev = default_device(device)
    _check_device(dev, xyz, opacity, color, feature, alive)
    cam = cam.to(dev)
    P = xyz.shape[0]
    prep = preprocess(xyz, cov3d, cam, alive, near=cfg.near, low_pass=cfg.low_pass)
    key = torch.where(prep.valid, prep.depth, torch.full_like(prep.depth, float("inf")))
    order = torch.sort(key, stable=True).indices
    values = torch.cat([color, prep.depth[:, None], feature], dim=-1)
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    xmin, xmax, ymin, ymax = binning_lib.tile_rect(prep.mean2d, prep.radius,
                                                   tiles_x, tiles_y, cfg.tile)
    rect = torch.stack([xmin, xmax, ymin, ymax], dim=-1).to(torch.float32)

    pad = (-P) % cfg.chunk
    idx = torch.cat([order, torch.full((pad,), P, dtype=order.dtype, device=dev)])[None, :]
    H, W = cam.height, cam.width
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    out = composite_tiles(
        pad_row(prep.mean2d)[idx], pad_row(prep.conic)[idx],
        pad_row(opacity * prep.valid)[idx], pad_row(values)[idx],
        xs.reshape(1, -1), ys.reshape(1, -1), cfg, rect=pad_row(rect)[idx],
    )
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    no_table = torch.zeros((0,), dtype=torch.int32, device=dev)
    return render_output(out.values.reshape(H, W, -1), out.final_t.reshape(H, W), bg,
                         prep.radius, zero, zero, no_table, no_table)
