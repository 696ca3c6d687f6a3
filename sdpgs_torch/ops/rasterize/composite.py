"""Per-tile front-to-back alpha compositing in plain PyTorch.

Counterpart of ``sdpgs_tpu/ops/rasterize/composite_xla.py`` (reference
forward.cu:261-374): per pixel, Gaussians composite front to back with

  alpha = min(0.99, opacity * exp(power)),  power = -0.5 (a dx^2 + c dy^2) - b dx dy

skipping alpha < 1/255 or power > 0, and halting when transmittance would
drop below 1e-4. A chunk of G entries x npix pixels takes a cumulative
product of (1 - alpha) for each entry's incoming transmittance; a carried
"done" flag keeps the exact contributor set across chunks. This is the
plain version behind kernels K3 and K5 (``composite_cuda.py``); autograd
differentiates it (``cumprod`` has a gradient, as in composite_xla.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sdpgs_torch.config import RasterizeConfig


class TileOutputs(NamedTuple):
    values: torch.Tensor   # [T, npix, C] composited channels (premultiplied)
    final_t: torch.Tensor  # [T, npix] final transmittance
    n_visit: Optional[torch.Tensor] = None  # [T, npix] int32 entries each
                                            # pixel evaluated (kernel only)


def tile_pixel_coords(num_tiles_x: int, num_tiles_y: int, tile: int,
                      device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates for every tile: ([T, npix] x, [T, npix] y)."""
    f32 = torch.float32
    ty, tx = torch.meshgrid(torch.arange(num_tiles_y, dtype=f32, device=device),
                            torch.arange(num_tiles_x, dtype=f32, device=device),
                            indexing="ij")
    origin_x = (tx * tile).reshape(-1, 1)
    origin_y = (ty * tile).reshape(-1, 1)
    ly, lx = torch.meshgrid(torch.arange(tile, dtype=f32, device=device),
                            torch.arange(tile, dtype=f32, device=device), indexing="ij")
    return origin_x + lx.reshape(1, -1), origin_y + ly.reshape(1, -1)


def tile_pixel_coords_range(t0: int, n_local: int, num_tiles_x: int, tile: int,
                            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates for the ``n_local`` tiles from flat tile
    ``t0`` (a tile-sharded render's range; composite_xla.py:59-75):
    ([n_local, npix] x, [n_local, npix] y)."""
    f32 = torch.float32
    tiles = t0 + torch.arange(n_local, dtype=torch.int32, device=device)
    origin_x = (tiles % num_tiles_x).to(f32)[:, None] * tile
    origin_y = (tiles // num_tiles_x).to(f32)[:, None] * tile
    ly, lx = torch.meshgrid(torch.arange(tile, dtype=f32, device=device),
                            torch.arange(tile, dtype=f32, device=device), indexing="ij")
    return origin_x + lx.reshape(1, -1), origin_y + ly.reshape(1, -1)


def composite_tiles(
    xy: torch.Tensor,        # [T, K, 2] gathered Gaussian centers (pixels)
    conic: torch.Tensor,     # [T, K, 3]
    opacity: torch.Tensor,   # [T, K]
    values: torch.Tensor,    # [T, K, C] channels to composite
    px: torch.Tensor,        # [T, npix]
    py: torch.Tensor,        # [T, npix]
    cfg: RasterizeConfig,
    rect: Optional[torch.Tensor] = None,  # [T, K, 4] tile-granular rect
) -> TileOutputs:
    """``rect`` (xmin, xmax, ymin, ymax in tile units, exclusive max) lets the
    untiled golden renderer apply the binned path's tile-rect cutoff."""
    T_tiles, K = opacity.shape
    chunk = cfg.chunk
    if K % chunk:
        raise ValueError(f"K={K} must be a multiple of chunk={chunk}")
    if rect is not None:
        tile_x = torch.floor(px / cfg.tile)
        tile_y = torch.floor(py / cfg.tile)
    t_in = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    acc = torch.zeros((T_tiles, px.shape[-1], values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    for g0 in range(0, K, chunk):
        sl = slice(g0, g0 + chunk)
        dx = xy[:, sl, 0][:, :, None] - px[:, None, :]        # [T, G, npix]
        dy = xy[:, sl, 1][:, :, None] - py[:, None, :]
        a = conic[:, sl, 0][:, :, None]
        b = conic[:, sl, 1][:, :, None]
        c = conic[:, sl, 2][:, :, None]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        # exp of min(power, 0): where power > 0 the entry is masked below,
        # and exp(power) there could overflow and turn the masked zero
        # gradient into 0 * inf = NaN
        alpha = torch.clamp_max(opacity[:, sl, None] * torch.exp(torch.clamp_max(power, 0.0)),
                                cfg.alpha_max)
        alpha = torch.where((power > 0.0) | (alpha < cfg.alpha_min),
                            torch.zeros_like(alpha), alpha)
        if rect is not None:
            r = rect[:, sl]
            inside = ((tile_x[:, None, :] >= r[:, :, 0, None])
                      & (tile_x[:, None, :] < r[:, :, 1, None])
                      & (tile_y[:, None, :] >= r[:, :, 2, None])
                      & (tile_y[:, None, :] < r[:, :, 3, None]))
            alpha = torch.where(inside, alpha, torch.zeros_like(alpha))
        cum = t_in[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)   # inclusive
        active = (cum >= cfg.transmittance_min) & ~done[:, None, :]
        alpha_eff = alpha * active
        # exclusive incoming transmittance; exact while `active` is a prefix
        t_excl = torch.cat([t_in[:, None, :], cum[:, :-1, :]], dim=1)
        w = alpha_eff * t_excl                                # [T, G, npix]
        acc = acc + torch.einsum("tgp,tgc->tpc", w, values[:, sl])
        t_in = t_in * torch.prod(1.0 - alpha_eff, dim=1)
        done = done | torch.any(cum < cfg.transmittance_min, dim=1)
    return TileOutputs(values=acc, final_t=t_in)


def assemble_image(tiles: torch.Tensor, tiles_x: int, tiles_y: int, tile: int,
                   height: int, width: int) -> torch.Tensor:
    """[T, npix, C] tile buffers -> [H, W, C] image (crop edge padding)."""
    C = tiles.shape[-1]
    img = tiles.reshape(tiles_y, tiles_x, tile, tile, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, C)
    return img[:height, :width]
