"""Tile-partitioned rasterization over the mesh's ``tile`` axis.

Counterpart of ``sdpgs_tpu/parallel/tile_shard.py`` (there under
``jax.shard_map``); ``render(..., tile_mesh=mesh)`` routes a view here
when the mesh's ``tile`` axis exceeds 1. Each rank of the axis

  1. takes the render's K1 preprocess of every Gaussian (replicated:
     per-Gaussian work);
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

import torch

from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.ops.rasterize import binning as binning_lib
from sdpgs_torch.ops.rasterize.composite import assemble_image
from sdpgs_torch.ops.rasterize.payload import Payload
from sdpgs_torch.ops.rasterize.rasterizer import RenderOutput, rasterize_tiles, render_output
from sdpgs_torch.parallel import comm
from sdpgs_torch.parallel.mesh import Mesh


def rasterize_tile_sharded(payload: Payload, cam: Camera, bg, cfg: RasterizeConfig,
                           mesh: Mesh) -> RenderOutput:
    """Differentiable render of one view from K1's ``payload`` with the tile
    grid sharded over ``mesh``'s ``tile`` axis (``render(...,
    tile_mesh=mesh)`` calls it); the same outputs as ``rasterize`` on every
    rank of the axis: overflow summed over the shards, clipped and radii
    replicated; tile_counts and tile_totals those of this rank's tiles (the
    Trainer sums and maxes them over the ranks at its log points). The
    inputs are replicated on every rank of the axis."""
    group = mesh.group("tile")
    n, index = mesh.shape["tile"], mesh.coords["tile"]
    tiles_x, tiles_y = binning_lib.tile_grid(cam.width, cam.height, cfg.tile)
    num_tiles = tiles_x * tiles_y
    n_local = -(-num_tiles // n)
    cam = cam.to(payload.rows.device)
    out, bins = rasterize_tiles(
        payload, cam, cfg, tile_range=(index * n_local, n_local),
        payload_grad=lambda rows: comm.sum_grad(rows, group))
    # one gather of the shard's 7 channels and final transmittance
    local = torch.cat([out.values, out.final_t[..., None]], dim=-1)
    tiles = comm.gather_tiles(local, group)[:num_tiles]
    img = assemble_image(tiles, tiles_x, tiles_y, cfg.tile, cam.height, cam.width)
    overflow = comm.all_sum(bins.overflow.clone(), group)
    return render_output(img[..., :7], img[..., 7], bg, payload.screen.radius, overflow,
                         bins.clipped, bins.tile_counts, bins.tile_totals)
