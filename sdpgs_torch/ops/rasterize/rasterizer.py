"""Rasterizer API: preprocess -> bin -> gather + composite -> image.

Counterpart of ``sdpgs_tpu/ops/rasterize/rasterizer.py``: the extended
outputs the framework consumes (reference gaussian_renderer/__init__.py:
315-326): color, expected depth, alpha, 3-channel feature image, radii,
plus capacity telemetry. ``rasterize`` is differentiable: gradients flow
through the payload (K3/K5 on CUDA); binning consumes detached geometry.
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
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed, preprocess


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


def _pad_row(a: torch.Tensor) -> torch.Tensor:
    """Append one zero 'dead' row: binning sentinel index P points here."""
    return torch.cat([a, torch.zeros_like(a[:1])], dim=0)


def _check_device(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t is not None and t.device.type != device.type:
            raise ValueError(f"input on {t.device}, render device is {device}")


def make_payload(prep: Preprocessed, opacity, color, feature) -> torch.Tensor:
    """The [P+1, 13] f32 rows the compositor gathers: mean2d xy, conic abc,
    opacity*valid, rgb, depth, feature xyz; row P is the zero sentinel."""
    return _pad_row(torch.cat([
        prep.mean2d,                              # 0:2
        prep.conic,                               # 2:5
        (opacity * prep.valid)[:, None],          # 5
        color,                                    # 6:9
        prep.depth[:, None],                      # 9
        feature,                                  # 10:13
    ], dim=-1).to(torch.float32)).contiguous()


def render_output(vals, final_t, bg, prep: Preprocessed, overflow, clipped, tile_counts,
                  tile_totals) -> RenderOutput:
    """The outputs of one view from its composited ``vals`` [H, W, 7] (rgb,
    expected depth, feature), final transmittance ``final_t`` [H, W] and
    background ``bg`` [3], the preprocess's radii and the binning telemetry."""
    bg = torch.as_tensor(bg, dtype=torch.float32, device=vals.device)
    radii = prep.radius.detach()
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


def rasterize_tiles(
    xyz, cov3d, opacity, color, feature, alive, cam: Camera, cfg: RasterizeConfig,
    means2d_offset=None, feature_weight=None, prep: Optional[Preprocessed] = None,
    tile_range: Optional[tuple[int, int]] = None,
    payload_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[TileOutputs, binning_lib.Binning, Preprocessed]:
    """Preprocess -> bin -> gather + composite for every tile, or with
    ``tile_range=(t0, n_local)`` for the ``n_local`` tiles from flat tile
    ``t0`` (a tile-sharded render's shard; JAX rasterizer.py:95-200).

    ``prep``: precomputed screen-space quantities (the fused kernel K1,
    ``preprocess_cuda.preprocess_color``); otherwise the plain preprocess
    from ``cov3d``. ``payload_grad`` wraps the [P+1, 13] payload before the
    compositing: the tile-sharded render passes the sum of its gradient over
    the tile axis there."""
    if prep is None:
        prep = preprocess(xyz, cov3d, cam, alive, near=cfg.near, low_pass=cfg.low_pass)
    mean2d = prep.mean2d
    if means2d_offset is not None:
        mean2d = mean2d + means2d_offset
    # binning consumes geometry only; gradients flow through the payload
    bins = binning_lib.bin_gaussians(
        Preprocessed(*(t.detach() for t in prep._replace(mean2d=mean2d))),
        cam.width, cam.height, cfg, tile_range=tile_range)
    if feature_weight is not None:
        feature = feature * feature_weight[:, None]
    payload = make_payload(prep._replace(mean2d=mean2d), opacity, color, feature)
    if payload_grad is not None:
        payload = payload_grad(payload)
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    out = composite_gather(payload, bins.tile_index, bins.tile_counts, tiles_x, tiles_y, cfg,
                           xyz.shape[0], t0=0 if tile_range is None else tile_range[0],
                           rects=bins.rects)
    return out, bins, prep


def rasterize(
    xyz: torch.Tensor,          # [P, 3]
    cov3d: Optional[torch.Tensor],  # [P, 3, 3] world covariance
    opacity: torch.Tensor,      # [P] activated opacity (dead slots zero)
    color: torch.Tensor,        # [P, 3] per-Gaussian RGB
    feature: torch.Tensor,      # [P, 3] per-Gaussian language feature
    alive: torch.Tensor,        # [P] float mask
    cam: Camera,
    bg,                         # [3]
    cfg: RasterizeConfig,
    means2d_offset=None,
    feature_weight=None,
    prep: Optional[Preprocessed] = None,
    device=None,
) -> RenderOutput:
    """Differentiable render of one view on ``device`` (``cuda`` unless the
    caller asks for another); the inputs must already live there. ``prep``
    (kernel K1's output) takes the place of the plain preprocess from
    ``cov3d``; ``feature_weight`` scales the feature channels per Gaussian
    (the reference's ``confidence``). ``means2d_offset`` [P, 2] (zeros) is
    added to the screen centres: its gradient is the per-Gaussian
    screen-space gradient the densification statistics read (reference
    gaussian_renderer/__init__.py:217-221)."""
    dev = default_device(device)
    _check_device(dev, xyz, opacity, color, feature, alive)
    cam = cam.to(dev)
    out, bins, prep = rasterize_tiles(
        xyz, cov3d, opacity, color, feature, alive, cam, cfg,
        means2d_offset=means2d_offset, feature_weight=feature_weight,
        prep=prep,
    )
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    H, W = cam.height, cam.width
    vals = assemble_image(out.values, tiles_x, tiles_y, cfg.tile, H, W)
    final_t = assemble_image(out.final_t[..., None], tiles_x, tiles_y, cfg.tile, H, W)[..., 0]
    return render_output(vals, final_t, bg, prep, bins.overflow, bins.clipped, bins.tile_counts,
                         bins.tile_totals)


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
        _pad_row(prep.mean2d)[idx], _pad_row(prep.conic)[idx],
        _pad_row(opacity * prep.valid)[idx], _pad_row(values)[idx],
        xs.reshape(1, -1), ys.reshape(1, -1), cfg, rect=_pad_row(rect)[idx],
    )
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    no_table = torch.zeros((0,), dtype=torch.int32, device=dev)
    return render_output(out.values.reshape(H, W, -1), out.final_t.reshape(H, W), bg, prep,
                         zero, zero, no_table, no_table)
