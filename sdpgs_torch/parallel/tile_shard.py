"""Tile-partitioned rasterization over the mesh's ``tile`` axis.

Counterpart of ``sdpgs_tpu/parallel/tile_shard.py`` (there under
``jax.shard_map``). Each rank of the axis

  1. preprocesses every Gaussian (K1, replicated: per-Gaussian work);
  2. bins only the ``n_local = ceil(T / n)`` tiles it owns, from flat tile
     ``t0 = index * n_local`` (``bin_gaussians(tile_range=...)``, K2 with a
     tile offset): a within-tile rank depends only on that tile, so no
     shard needs another's ranks;
  3. composites its tiles (K3 with the offset); the rows past the grid of
     the last shard composite nothing.

The shards' rows are then gathered into the whole image on every rank of
the axis, which each compute the same loss from it. The backward hands
each rank its rows of the image's cotangent (K5 on its tiles) and sums the
payload gradient over the axis before K4 runs on it: the counterpart of
the psum that ``shard_map``'s transpose inserts there, and of the
reference backward's atomicAdd of per-pixel gradients into per-Gaussian
slots (backward.cu:523-554). The screen-space offset's gradient rides in
the payload's mean2d columns, so it too is summed over the tiles before
the densification statistics take its norm.
"""

from __future__ import annotations

from typing import Optional

import torch

from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.ops.rasterize import binning as binning_lib
from sdpgs_torch.ops.rasterize.composite import assemble_image
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed
from sdpgs_torch.ops.rasterize.preprocess_cuda import preprocess_color
from sdpgs_torch.ops.rasterize.rasterizer import RenderOutput, rasterize_tiles
from sdpgs_torch.parallel import comm
from sdpgs_torch.parallel.mesh import Mesh


def rasterize_tile_sharded(
    xyz: torch.Tensor,
    cov3d: Optional[torch.Tensor],
    opacity: torch.Tensor,
    color: torch.Tensor,
    feature: torch.Tensor,
    alive: torch.Tensor,
    cam: Camera,
    bg,
    cfg: RasterizeConfig,
    mesh: Mesh,
    axis: str = "tile",
    means2d_offset: Optional[torch.Tensor] = None,
    feature_weight: Optional[torch.Tensor] = None,
    prep: Optional[Preprocessed] = None,
) -> RenderOutput:
    """Differentiable render of one view with the tile grid sharded over
    ``mesh``'s ``axis``; the same outputs as ``rasterize`` on every rank of
    the axis: overflow summed over the shards, clipped and radii replicated,
    slab 0. The inputs are replicated on every rank of the axis."""
    group = mesh.group(axis)
    n, index = mesh.shape[axis], mesh.coords[axis]
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    num_tiles = tiles_x * tiles_y
    n_local = -(-num_tiles // n)
    dev = xyz.device
    cam = cam.to(dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    out, bins, prep = rasterize_tiles(
        xyz, cov3d, opacity, color, feature, alive, cam, cfg,
        means2d_offset=means2d_offset, feature_weight=feature_weight, prep=prep,
        tile_range=(index * n_local, n_local),
        payload_grad=lambda payload: comm.sum_grad(payload, group))
    # one gather of the shard's 7 channels and final transmittance
    local = torch.cat([out.values, out.final_t[..., None]], dim=-1)
    tiles = comm.gather_tiles(local, group)[:num_tiles]
    img = assemble_image(tiles, tiles_x, tiles_y, cfg.tile, cam.height, cam.width)
    vals, final_t = img[..., :7], img[..., 7]
    overflow = comm.all_sum(bins.overflow.clone(), group)
    return RenderOutput(
        color=vals[..., :3] + final_t[..., None] * bg[None, None, :],
        depth=vals[..., 3],
        alpha=1.0 - final_t,
        feature=vals[..., 4:7],
        radii=prep.radius.detach(),
        visibility=prep.radius.detach() > 0.0,
        overflow=overflow,
        clipped=bins.clipped,
        slab=torch.zeros((), dtype=torch.int32, device=dev),
    )


def render_tile_sharded(
    cam: Camera,
    g: Gaussians,
    cfg: RasterizeConfig,
    bg,
    active_sh_degree: int,
    mesh: Mesh,
    axis: str = "tile",
    means2d_offset: Optional[torch.Tensor] = None,
    confidence: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Tile-sharded twin of ``sdpgs_torch.render.render``: K1 on every
    Gaussian, then :func:`rasterize_tile_sharded`."""
    prep, color = preprocess_color(g.xyz, g.get_scaling(), g.get_rotation(), g.get_features(),
                                   g.alive, cam, active_sh_degree, near=cfg.near,
                                   low_pass=cfg.low_pass)
    return rasterize_tile_sharded(
        g.xyz, None, g.get_opacity()[:, 0], color, g.language_feature_normalized(), g.alive,
        cam, bg, cfg, mesh, axis=axis, means2d_offset=means2d_offset,
        feature_weight=confidence[:, 0] if confidence is not None else None, prep=prep)
