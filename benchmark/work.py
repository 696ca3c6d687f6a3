"""The work a step or a view needs, counted from shapes and from the
entries the reference's binning lists for the state a traced run reads.

Bytes are what each function must move, each input read once and each
output written once: ``chip_smoke.py``'s bounds (K1 and K4 the rows of
every slot, K2 the visible rects and ids in and its table out, K3 and K5
the listed entries and the payload rows they reference and the pixels'
channels, K5 also the payload gradient), made functions of shape and
entry count, and Adam and the losses counted alike. Floating-point
operations are the depth net's matrix products and convolutions at its
input size. Entry counts are those of the state a traced run reads, never
the most they could be.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.raster import Raster, bin_tiles, row_math, tile_grid

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
F32 = 4
NGEO, NOUT = 11, 11            # K1's geometry rows in and rows out
PAYLOAD = 13                   # composited payload row: xy, conic, opacity, rgb, depth, feature
CHANNELS = 7                   # composited channels: rgb, depth, feature
PARAM_FLOATS = 3 + 3 + 45 + 3 + 4 + 1 + 3   # xyz, dc, rest (degree 3), scale, rot, opacity, feature


@dataclass
class ViewWork:
    """One view's rasterizer at one state."""

    pixels: int        # H x W
    tiles: int         # T
    npix: int          # tile x tile
    capacity: int      # P, the slots K1 and K4 sweep
    visible: int       # Gaussians with a rect (K2 reads them)
    K: int             # per-tile slots of K2's table
    entries: int       # listed (tile, Gaussian) entries
    rows_read: int     # distinct Gaussians listed

    def k1(self, sh_degree: int) -> int:
        return (NGEO + 3 * (sh_degree + 1) ** 2 + NOUT) * F32 * self.capacity

    def k2(self) -> int:
        # the visible Gaussians' rects and ids read, the table and counts written
        return (2 * self.visible + 1 + self.tiles * self.K + self.tiles) * F32

    def k3(self) -> int:
        reads = self.rows_read * PAYLOAD * F32 + self.entries * F32
        return reads + (self.tiles + self.tiles * self.npix * (CHANNELS + 1)) * F32

    def k4(self, sh_degree: int) -> int:
        return (3 * NGEO + 2 * 3 * (sh_degree + 1) ** 2) * F32 * self.capacity

    def k5(self) -> int:
        reads = self.rows_read * PAYLOAD * F32 + self.entries * F32
        # the payload gradient written, and per pixel the upstream gradients,
        # final transmittance and last contributor read
        return (reads + (self.capacity + 1) * PAYLOAD * F32
                + self.tiles * self.npix * (CHANNELS + 3) * F32)

    def forward(self, sh_degree: int) -> int:
        return self.k1(sh_degree) + self.k2() + self.k3()

    def backward(self, sh_degree: int) -> int:
        return self.k4(sh_degree) + self.k5()


@torch.no_grad()
def view_work(geometry: dict, cam, cfg: Raster, sh_degree: int) -> ViewWork:
    """Bin ``cam``'s view of a state's geometry (xyz, scaling, rotation,
    alive) with the reference and count what the view needs."""
    P = geometry["xyz"].shape[0]
    alive = geometry["alive"]
    quat = geometry["rotation"]
    quat = quat / torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True) + 1e-24)
    geo = torch.cat([geometry["xyz"].T, torch.exp(geometry["scaling"]).T, quat.T,
                     alive.reshape(1, P)], 0)
    sh = torch.zeros((3, P), device=geo.device)
    out = row_math(geo, sh, cam.vec(), deg=0, width=cam.width, height=cam.height,
                   near=cfg.near, low_pass=cfg.low_pass)
    valid = out[0] > 0.0
    bins = bin_tiles(torch.stack([out[1], out[2]], -1), out[7], valid, out[3], cam.width,
                     cam.height, cfg)
    tx, ty = tile_grid(cam.width, cam.height, cfg.tile)
    return ViewWork(pixels=cam.width * cam.height, tiles=tx * ty, npix=cfg.tile ** 2,
                    capacity=P, visible=bins.visible, K=cfg.max_per_tile,
                    entries=bins.entries, rows_read=bins.rows_read)


def loss_bytes(pixels: int, pseudo: bool) -> int:
    """A train view's losses read its 7 rendered channels and 8 target
    channels (image, depth prior, feature, segment) and write 7 gradient
    channels; a pseudo view reads 7 channels and the fused depth and
    weight and writes 7."""
    return (7 + 2 + 7 if pseudo else 7 + 8 + 7) * F32 * pixels


def adam_bytes(live: int) -> int:
    """Adam reads parameter, gradient and both moments and writes the
    parameter and both moments of every live Gaussian's floats."""
    return 7 * F32 * PARAM_FLOATS * live


def depth_net_flops(cfg: dict) -> float:
    """The depth net's forward and input-gradient operations at its input
    size (its matrix products and convolutions, counted from their shapes
    on the meta device: the weights take no gradient)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import program
    from benchmark.reference import dpt as ref_dpt

    d = cfg["depth_net"]
    H, W = cfg["image"]["height"], cfg["image"]["width"]
    with torch.device("meta"):
        net = ref_dpt.DPT(program.ref_dpt_arch(cfg), image_size=d["image_size"])
        mono = ref_dpt.MonoDepth(net, dtype=getattr(torch, d["dtype"]), resize_method=d["resize"])
        image = torch.empty((3, H, W), requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        out = mono(image)
        out.backward(torch.ones_like(out))
    return float(fc.get_total_flops())

