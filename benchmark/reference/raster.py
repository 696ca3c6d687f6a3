"""The reference rasterizer: preprocess and SH colour, tile binning, and
front-to-back compositing, differentiable by autograd.

Copied from ``sdpgs_torch/ops/rasterize/preprocess_cuda.py`` (the row math
of kernel K1's plain version), ``binning.py`` (the plain table of K2, with
the per-tile cap K and the per-Gaussian cap D) and ``composite.py`` and
``rasterizer.py`` (the chunked compositing of K3's plain version). The
compositing runs over blocks of tiles, each cut to its longest tile list
and recomputed in the backward (``torch.utils.checkpoint``), so a view at
the benchmark's sizes fits beside nothing else; the sums are the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.camera import Cam

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
      0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
# tile entries composited in one block (entries x 1,024 pixels per
# intermediate): about 16 GB of saved tensors while a block recomputes
BLOCK_ENTRIES = 1 << 18


@dataclass(frozen=True)
class Raster:
    """The fields of the program's RasterizeConfig that the port reads."""

    tile: int = 32
    max_per_tile: int = 1024
    max_tiles_per_gaussian: int = 8
    chunk: int = 32
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    transmittance_min: float = 1e-4
    near: float = 0.2
    low_pass: float = 0.3


def ndc_to_pixel(v, size: int):
    return ((v + 1.0) * size - 1.0) * 0.5


def row_math(geo, sh, cam, *, deg: int, width: int, height: int,
             near: float, low_pass: float):
    """The preprocess+SH chain on [NGEO, N] geometry and [3*(deg+1)^2, N]
    SH rows with the [39] camera vector; returns 11 [N] rows: valid,
    mean x, mean y, depth, conic a b c, radius, r g b."""
    x, y, z = geo[0], geo[1], geo[2]
    s0, s1, s2 = geo[3], geo[4], geo[5]
    r, qx, qy, qz = geo[6], geo[7], geo[8], geo[9]
    alive = geo[10]
    V = [cam[i] for i in range(16)]           # row-major view
    FP = [cam[16 + i] for i in range(16)]
    fx, fy = cam[32], cam[33]
    tan_fovx, tan_fovy = cam[34], cam[35]
    cpx, cpy, cpz = cam[36], cam[37], cam[38]

    tx = V[0] * x + V[1] * y + V[2] * z + V[3]
    ty = V[4] * x + V[5] * y + V[6] * z + V[7]
    tz = V[8] * x + V[9] * y + V[10] * z + V[11]
    depth = tz

    hx = FP[0] * x + FP[1] * y + FP[2] * z + FP[3]
    hy = FP[4] * x + FP[5] * y + FP[6] * z + FP[7]
    hw = FP[12] * x + FP[13] * y + FP[14] * z + FP[15]
    inv_w = 1.0 / (hw + 1e-7)
    mx = ndc_to_pixel(hx * inv_w, width)
    my = ndc_to_pixel(hy * inv_w, height)

    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - r * qz)
    R02 = 2 * (qx * qz + r * qy)
    R10 = 2 * (qx * qy + r * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - r * qx)
    R20 = 2 * (qx * qz - r * qy)
    R21 = 2 * (qy * qz + r * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)

    def wrow(i):
        return (
            V[4 * i + 0] * R00 + V[4 * i + 1] * R10 + V[4 * i + 2] * R20,
            V[4 * i + 0] * R01 + V[4 * i + 1] * R11 + V[4 * i + 2] * R21,
            V[4 * i + 0] * R02 + V[4 * i + 1] * R12 + V[4 * i + 2] * R22,
        )

    A00, A01, A02 = wrow(0)
    A10, A11, A12 = wrow(1)
    A20, A21, A22 = wrow(2)
    A00, A01, A02 = A00 * s0, A01 * s1, A02 * s2
    A10, A11, A12 = A10 * s0, A11 * s1, A12 * s2
    A20, A21, A22 = A20 * s0, A21 * s1, A22 * s2

    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    ux, uy = tx / tz_safe, ty / tz_safe
    cx = torch.clamp(ux, -lim_x, lim_x) * tz_safe
    cy = torch.clamp(uy, -lim_y, lim_y) * tz_safe
    j00 = fx / tz_safe
    j02 = -(fx * cx) / (tz_safe * tz_safe)
    j11 = fy / tz_safe
    j12 = -(fy * cy) / (tz_safe * tz_safe)
    m00 = j00 * A00 + j02 * A20
    m01 = j00 * A01 + j02 * A21
    m02 = j00 * A02 + j02 * A22
    m10 = j11 * A10 + j12 * A20
    m11 = j11 * A11 + j12 * A21
    m12 = j11 * A12 + j12 * A22

    a = m00 * m00 + m01 * m01 + m02 * m02 + low_pass
    b = m00 * m10 + m01 * m11 + m02 * m12
    c = m10 * m10 + m11 * m11 + m12 * m12 + low_pass

    det = a * c - b * b
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    ca, cb, cc = c * inv_det, -b * inv_det, a * inv_det

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc, 0.0)))

    validf = (
        (depth > near) & (det != 0.0) & (radius > 0.0) & (alive > 0.0)
        & torch.isfinite(depth)
    ).to(geo.dtype)
    radius = radius * validf

    # SH colour at the normalized view direction (colors_from_sh,
    # reference gaussian_renderer/__init__.py:269-274)
    dx, dy_, dz = x - cpx, y - cpy, z - cpz
    inv_n = torch.rsqrt(dx * dx + dy_ * dy_ + dz * dz + 1e-24)
    dx, dy_, dz = dx * inv_n, dy_ * inv_n, dz * inv_n

    def coef(k, ch):
        return sh[3 * k + ch]

    rgb = []
    for ch in range(3):
        res = C0 * coef(0, ch)
        if deg > 0:
            res = (
                res - C1 * dy_ * coef(1, ch)
                + C1 * dz * coef(2, ch)
                - C1 * dx * coef(3, ch)
            )
            if deg > 1:
                xx, yy, zz = dx * dx, dy_ * dy_, dz * dz
                xy, yz2, xz = dx * dy_, dy_ * dz, dx * dz
                res = (
                    res
                    + C2[0] * xy * coef(4, ch)
                    + C2[1] * yz2 * coef(5, ch)
                    + C2[2] * (2.0 * zz - xx - yy) * coef(6, ch)
                    + C2[3] * xz * coef(7, ch)
                    + C2[4] * (xx - yy) * coef(8, ch)
                )
                if deg > 2:
                        res = (
                        res
                        + C3[0] * dy_ * (3.0 * xx - yy) * coef(9, ch)
                        + C3[1] * xy * dz * coef(10, ch)
                        + C3[2] * dy_ * (4.0 * zz - xx - yy) * coef(11, ch)
                        + C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coef(12, ch)
                        + C3[4] * dx * (4.0 * zz - xx - yy) * coef(13, ch)
                        + C3[5] * dz * (xx - yy) * coef(14, ch)
                        + C3[6] * dx * (xx - 3.0 * yy) * coef(15, ch)
                    )
        rgb.append(torch.clamp_min(res + 0.5, 0.0))

    return (validf, mx, my, depth, ca, cb, cc, radius, rgb[0], rgb[1], rgb[2])


# ---- binning (binning.py) --------------------------------------------------

def tile_grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return -(-width // tile), -(-height // tile)


def tile_rect(mean2d, radius, tiles_x: int, tiles_y: int, tile: int):
    t = float(tile)

    def cell(v, hi):
        return torch.clamp(torch.floor(v / t), 0, hi).to(torch.int32)

    return (cell(mean2d[:, 0] - radius, tiles_x), cell(mean2d[:, 0] + radius + t - 1, tiles_x),
            cell(mean2d[:, 1] - radius, tiles_y), cell(mean2d[:, 1] + radius + t - 1, tiles_y))


@dataclass
class Bins:
    table: torch.Tensor     # [T, K] int32 Gaussian ids, sentinel P
    counts: torch.Tensor    # [T] int32 entries listed per tile (<= K)
    overflow: int           # entries dropped by the K cap
    clipped: int            # tile slots dropped by the D cap
    entries: int            # listed (tile, Gaussian) entries
    rows_read: int          # distinct Gaussians listed
    visible: int            # Gaussians with a non-empty rect


@torch.no_grad()
def bin_tiles(mean2d, radius, valid, depth, width: int, height: int, cfg: Raster) -> Bins:
    """Depth-sorted per-tile lists (stable sort; culled Gaussians last with
    empty rects), each Gaussian's rect enumerated row-major and cut at D
    tiles, each tile's list cut at K entries."""
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile)
    T, K, D = tiles_x * tiles_y, cfg.max_per_tile, cfg.max_tiles_per_gaussian
    P = mean2d.shape[0]
    dev = mean2d.device
    xmin, xmax, ymin, ymax = tile_rect(mean2d, radius, tiles_x, tiles_y, cfg.tile)
    count0 = (xmax - xmin) * (ymax - ymin)
    ok = valid & (count0 > 0)
    xmax = torch.where(ok, xmax, xmin)
    ymax = torch.where(ok, ymax, ymin)
    key = torch.where(ok, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(key, stable=True).indices
    xmin, xmax, ymin, ymax = xmin[order], xmax[order], ymin[order], ymax[order]
    rect_w = xmax - xmin
    count = rect_w * (ymax - ymin)
    d = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    rw = torch.clamp_min(rect_w, 1)[:, None]
    tid = (ymin[:, None] + d // rw) * tiles_x + xmin[:, None] + d % rw
    entry_valid = (count[:, None] > 0) & (d < count[:, None])
    tid = torch.where(entry_valid, tid, torch.full_like(tid, -1))
    rank = torch.zeros((P, D), dtype=torch.int64, device=dev)
    totals = torch.zeros(T, dtype=torch.int64, device=dev)
    Tc = min(T, max(8, (1 << 24) // max(P, 1)))
    column = torch.arange(P, device=dev)[:, None]
    for c0 in range(0, T, Tc):
        tiles = torch.arange(c0, min(c0 + Tc, T), dtype=torch.int32, device=dev)
        ctx, cty = tiles % tiles_x, tiles // tiles_x
        # [tiles, P]: the sorted Gaussians that cover each tile; a scan along
        # the Gaussians (the contiguous axis) ranks each within its tile
        mask = ((ctx[:, None] >= xmin[None, :]) & (ctx[:, None] < xmax[None, :])
                & (cty[:, None] >= ymin[None, :]) & (cty[:, None] < ymax[None, :]))
        mi = mask.to(torch.int32)
        excl = torch.cumsum(mi, dim=1, dtype=torch.int32) - mi
        local = (tid - c0).to(torch.int64)
        inside = (local >= 0) & (local < tiles.shape[0])
        got = excl[torch.where(inside, local, 0), column].to(torch.int64)
        rank = torch.where(inside, got, rank)
        totals[c0:c0 + tiles.shape[0]] = mi.sum(dim=1)
    keep = entry_valid & (rank < K)
    table = torch.full((T * K,), P, dtype=torch.int32, device=dev)
    gid = order.to(torch.int32)[:, None].expand(P, D)
    table[(tid.to(torch.int64) * K + rank)[keep]] = gid[keep]
    counts = torch.clamp_max(totals, K).to(torch.int32)
    listed = table.reshape(T, K)[torch.arange(K, device=dev)[None, :] < counts[:, None]]
    return Bins(table=table.reshape(T, K), counts=counts,
                overflow=int(torch.clamp_min(totals - K, 0).sum()),
                clipped=int(torch.clamp_min(count - D, 0).sum()),
                entries=int(listed.numel()), rows_read=int(torch.unique(listed).numel()),
                visible=int(ok.sum()))


# ---- compositing (composite.py) ---------------------------------------------

def tile_pixels(tiles_x: int, tiles_y: int, tile: int, device):
    f32 = torch.float32
    ty, tx = torch.meshgrid(torch.arange(tiles_y, dtype=f32, device=device),
                            torch.arange(tiles_x, dtype=f32, device=device), indexing="ij")
    ly, lx = torch.meshgrid(torch.arange(tile, dtype=f32, device=device),
                            torch.arange(tile, dtype=f32, device=device), indexing="ij")
    return ((tx * tile).reshape(-1, 1) + lx.reshape(1, -1),
            (ty * tile).reshape(-1, 1) + ly.reshape(1, -1))


def composite_tiles(xy, conic, opacity, values, px, py, cfg: Raster):
    """Per pixel, entries front to back: alpha = min(0.99, o exp(power)),
    skipped below 1/255 or for power > 0, halting before the
    transmittance falls under 1e-4. Returns ([T, npix, C], [T, npix])."""
    T_tiles, K = opacity.shape
    chunk = cfg.chunk
    t_in = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    acc = torch.zeros((T_tiles, px.shape[-1], values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    for g0 in range(0, K, chunk):
        sl = slice(g0, g0 + chunk)
        dx = xy[:, sl, 0][:, :, None] - px[:, None, :]
        dy = xy[:, sl, 1][:, :, None] - py[:, None, :]
        a = conic[:, sl, 0][:, :, None]
        b = conic[:, sl, 1][:, :, None]
        c = conic[:, sl, 2][:, :, None]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opacity[:, sl, None] * torch.exp(torch.clamp_max(power, 0.0)),
                                cfg.alpha_max)
        alpha = torch.where((power > 0.0) | (alpha < cfg.alpha_min),
                            torch.zeros_like(alpha), alpha)
        cum = t_in[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        active = (cum >= cfg.transmittance_min) & ~done[:, None, :]
        alpha_eff = alpha * active
        t_excl = torch.cat([t_in[:, None, :], cum[:, :-1, :]], dim=1)
        w = alpha_eff * t_excl
        acc = acc + torch.einsum("tgp,tgc->tpc", w, values[:, sl])
        t_in = t_in * torch.prod(1.0 - alpha_eff, dim=1)
        done = done | torch.any(cum < cfg.transmittance_min, dim=1)
    return acc, t_in


def composite(payload, bins: Bins, tiles_x: int, tiles_y: int, cfg: Raster):
    """Composite every tile from the [P+1, 13] payload, a block of tiles at
    a time, each block's lists cut to its longest (the sentinel slots past
    a tile's count add nothing). Returns ([T, npix, 7], [T, npix])."""
    px, py = tile_pixels(tiles_x, tiles_y, cfg.tile, payload.device)
    counts = bins.counts.tolist()
    T, chunk = len(counts), cfg.chunk
    vals, finals = [], []
    b0 = 0
    while b0 < T:
        b1, longest = b0, chunk
        while b1 < T:
            k = max(longest, -(-max(counts[b1], 1) // chunk) * chunk)
            if b1 > b0 and (b1 + 1 - b0) * k > BLOCK_ENTRIES:
                break
            longest, b1 = k, b1 + 1
        idx = bins.table[b0:b1, :longest].long()
        bx, by = px[b0:b1], py[b0:b1]

        def block(pay, idx=idx, bx=bx, by=by):
            g = pay[idx]
            return composite_tiles(g[..., 0:2], g[..., 2:5], g[..., 5], g[..., 6:13], bx, by,
                                   cfg)

        v, t = (checkpoint(block, payload, use_reentrant=False) if payload.requires_grad
                else block(payload))
        vals.append(v)
        finals.append(t)
        b0 = b1
    return torch.cat(vals), torch.cat(finals)


def assemble(tiles, tiles_x: int, tiles_y: int, tile: int, height: int, width: int):
    C = tiles.shape[-1]
    img = tiles.reshape(tiles_y, tiles_x, tile, tile, C)
    return img.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, C)[:height, :width]


# ---- the render (render/__init__.py, rasterizer.py) ------------------------

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
          "language_feature")


@dataclass
class Rendered:
    color: torch.Tensor      # [H, W, 3]
    depth: torch.Tensor      # [H, W]
    feature: torch.Tensor    # [H, W, 3]
    bins: Bins


def language_feature_normalized(f):
    f = f * C0
    return f / (torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True) + 1e-18) + 1e-9)


def render(g: dict, alive, cam: Cam, cfg: Raster, bg, sh_degree: int) -> Rendered:
    """One view of the cloud ``g`` (raw parameters by field name, [P, ...];
    ``alive`` [P] 0/1), differentiable in ``g``'s tensors."""
    P = g["xyz"].shape[0]
    K = (sh_degree + 1) ** 2
    quat = g["rotation"]
    quat = quat / torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True) + 1e-24)
    geo = torch.cat([g["xyz"].T, torch.exp(g["scaling"]).T, quat.T, alive.reshape(1, P)], 0)
    feats = torch.cat([g["features_dc"], g["features_rest"]], dim=1)
    sh = feats[:, :K, :].reshape(P, K * 3).T
    out = row_math(geo, sh, cam.vec(), deg=sh_degree, width=cam.width, height=cam.height,
                   near=cfg.near, low_pass=cfg.low_pass)
    valid = out[0] > 0.0
    mean2d = torch.stack([out[1], out[2]], dim=-1)
    depth = out[3]
    bins = bin_tiles(mean2d.detach(), out[7].detach(), valid, depth.detach(), cam.width,
                     cam.height, cfg)
    opacity = torch.sigmoid(g["opacity"])[:, 0] * alive
    rows = torch.cat([mean2d, torch.stack([out[4], out[5], out[6]], dim=-1),
                      (opacity * valid)[:, None], torch.stack([out[8], out[9], out[10]], -1),
                      depth[:, None], language_feature_normalized(g["language_feature"])], -1)
    payload = torch.cat([rows, torch.zeros_like(rows[:1])], 0)
    tiles_x, tiles_y = tile_grid(cam.width, cam.height, cfg.tile)
    vals, final_t = composite(payload, bins, tiles_x, tiles_y, cfg)
    H, W = cam.height, cam.width
    img = assemble(vals, tiles_x, tiles_y, cfg.tile, H, W)
    ft = assemble(final_t[..., None], tiles_x, tiles_y, cfg.tile, H, W)[..., 0]
    return Rendered(color=img[..., :3] + ft[..., None] * bg[None, None, :],
                    depth=img[..., 3], feature=img[..., 4:7], bins=bins)


def to_rgb8(color: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float -> uint8, as the viewer and the render CLI write it:
    clip to [0, 1], scale by 255, truncate."""
    return (torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)
