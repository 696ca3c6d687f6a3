"""K5's fixed reduction order (csrc/composite_bwd.cu), mirrored in numpy.

K5 adds no float atomically: each block (one 16x16 square of a tile, or a
whole 8- or 24-pixel tile) sums its warps' per-entry gradients in warp
order into a partials scratch at the entry's (row, square, slot); then one
thread per (Gaussian, field) adds the partials of the Gaussian's slots in
the order of its rect's tiles (d = 0 .. D-1, row-major, K2's D cap
enumeration) and, per slot, the tile's squares in order. The slots come
from an entry map [P, D] -> row * K + slot that entry_map_kernel writes
from the table and the packed rects (-1 where no slot holds (g, d)).

Here: the map's mirror against the plain binning (the tiles of each
Gaussian's rect, row-major, and its slot in each of those tiles' rows) at
the LLFF shape, with D clipping and K overflow (holes), from a tile offset
t0 > 0 and with rows past the grid; every listed entry is mapped exactly
once. Then the two stages simulated with autograd per warp patch at a small
shape: within SUM_TOL of the column max of composite_vjp_plain (float32
sums in another order), and bit-identical when the blocks run in shuffled
order. The mirror's constants are the kernel's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdpgs_torch.config import RasterizeConfig
from sdpgs_torch.ops.rasterize import binning, composite, composite_cuda
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed
from sdpgs_torch.ops.rasterize.rasterizer import make_payload
from torch_threads import few_threads  # noqa: F401  (autouse)

CSRC = Path(__file__).resolve().parents[1] / "sdpgs_torch" / "csrc"
SQUARE, PATCH_W, PATCH_H = 16, 8, 4     # composite_math.cuh (test_constants_match_the_kernel)
SMEM_LIMIT = 232_448                    # bytes of shared memory a block may opt in to (H100)
SUM_TOL = 1e-5                          # two-stage sum vs autograd, of the column max

# P, width, height, tile, K, D, radius range, dead share, tile range
CASES = {
    "llff": (20_000, 504, 378, 32, 1024, 8, (1, 40), 0.1, None),
    "d_clipping": (512, 96, 64, 16, 256, 2, (8, 30), 0.1, None),
    "k_overflow": (512, 64, 48, 16, 16, 8, (2, 14), 0.1, None),
    "tile_offset": (20_000, 504, 378, 32, 1024, 8, (1, 40), 0.1, (48, 48)),
    "past_the_grid": (20_000, 504, 378, 32, 1024, 8, (1, 40), 0.1, (168, 28)),
}


def make_prep(seed, P, width, height, radius_range, dead):
    rng = np.random.default_rng(seed)
    mean2d = np.stack([rng.uniform(-10, width + 10, P),
                       rng.uniform(-10, height + 10, P)], -1).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, P).astype(np.float32)
    valid = rng.random(P) > dead
    radius = np.where(valid, np.ceil(rng.uniform(*radius_range, P)), 0).astype(np.float32)
    # a positive-definite conic whose 3-sigma ellipse is about the radius
    s = (3.0 / np.maximum(radius, 1.0)) ** 2
    conic = np.stack([s * rng.uniform(0.5, 1.5, P), s * rng.uniform(-0.3, 0.3, P),
                      s * rng.uniform(0.5, 1.5, P)], -1).astype(np.float32)
    return Preprocessed(**{k: torch.from_numpy(v) for k, v in dict(
        valid=valid, mean2d=mean2d, depth=depth, conic=conic, radius=radius).items()})


def entry_map(table, rects, P, t0, grid_tiles, tiles_x, K, D):
    """entry_map_kernel: map[g, d] = row * K + slot of each listed entry."""
    rows, slots = np.nonzero((table >= 0) & (table < P))
    g = table[rows, slots]
    gt = t0 + rows
    r = rects[g]
    xmin, xmax, ymin, ymax = r & 0xFF, (r >> 8) & 0xFF, (r >> 16) & 0xFF, (r >> 24) & 0xFF
    tx, ty = gt % tiles_x, gt // tiles_x
    d = (ty - ymin) * (xmax - xmin) + (tx - xmin)
    keep = ((gt < grid_tiles) & (tx >= xmin) & (tx < xmax) & (ty >= ymin) & (ty < ymax)
            & (d < D))
    out = np.full((P, D), -1, np.int64)
    # one writer per (g, d): a second would race in the kernel
    assert len(set(zip(g[keep], d[keep]))) == int(keep.sum())
    out[g[keep], d[keep]] = (rows * K + slots)[keep]
    return out


def squares(tile: int) -> int:
    side = SQUARE if tile % SQUARE == 0 else tile
    return (tile // side) ** 2


def pixel_group(tile: int) -> np.ndarray:
    """[tile^2] the (square, warp) of each pixel of a tile (patch_pixel)."""
    side = SQUARE if tile % SQUARE == 0 else tile
    sx, px = tile // side, side // PATCH_W
    warps = side * side // 32
    group = np.empty(tile * tile, np.int64)
    for part in range(sx * sx):
        for warp in range(warps):
            for lane in range(32):
                lx = (part % sx) * side + (warp % px) * PATCH_W + lane % PATCH_W
                ly = (part // sx) * side + (warp // px) * PATCH_H + lane // PATCH_W
                group[ly * tile + lx] = part * warps + warp
    return group


@pytest.mark.parametrize("case", list(CASES))
def test_map_against_the_plain_binning(case):
    P, width, height, tile, K, D, rr, dead, tile_range = CASES[case]
    cfg = RasterizeConfig(tile=tile, max_per_tile=K, max_tiles_per_gaussian=D)
    bins = binning.bin_gaussians(make_prep(1, P, width, height, rr, dead), width, height, cfg,
                                 tile_range=tile_range)
    tiles_x, tiles_y = binning.tile_grid(width, height, tile)
    grid = tiles_x * tiles_y
    t0 = 0 if tile_range is None else tile_range[0]
    table = bins.tile_index.numpy()
    T = table.shape[0]
    rects = bins.rects.numpy()
    got = entry_map(table, rects, P, t0, grid, tiles_x, K, D)

    # the plain binning's enumeration: g's rect row-major, d < D, and g's
    # slot in each of those tiles' rows where the K cap kept it
    slot_of = {(int(r), int(table[r, k])): int(k) for r, k in zip(*np.nonzero(table < P))}
    xmin, xmax, ymin, ymax = (t.numpy() for t in binning.unpack_rect(bins.rects))
    want = np.full((P, D), -1, np.int64)
    for g in np.nonzero((xmax > xmin) & (ymax > ymin))[0]:
        w = xmax[g] - xmin[g]
        for d in range(min(D, w * (ymax[g] - ymin[g]))):
            tid = (ymin[g] + d // w) * tiles_x + xmin[g] + d % w
            k = slot_of.get((tid - t0, g)) if 0 <= tid - t0 < T else None
            if k is not None:
                want[g, d] = (tid - t0) * K + k
    np.testing.assert_array_equal(got, want)
    # every listed entry is summed exactly once
    listed = np.sort(np.flatnonzero((table >= 0) & (table < P)))
    np.testing.assert_array_equal(np.sort(got[got >= 0]), listed)
    if case == "d_clipping":
        assert int(bins.clipped) > 0 and (got[:, 1] == -1).any()
    if case == "k_overflow":
        assert int(bins.overflow) > 0
    if case == "past_the_grid":
        assert t0 + T > grid and (table[grid - t0:] == P).all()


def two_stage(partials_of_block, order, T, S, K, P, D, emap, tops, rects):
    """Stage 1 stores each block's partials at their positions (in the
    given block order); stage 2 adds them per Gaussian in map order, d
    below D and the Gaussian's rect's tile count (reduce_kernel)."""
    partial = np.zeros((T * S, K, composite_cuda.NPAY), np.float32)
    for b in order:
        partial[b, :tops[b]] = partials_of_block(b)[:tops[b]]
    out = np.zeros((P + 1, composite_cuda.NPAY), np.float32)
    xmin, xmax, ymin, ymax = rects & 0xFF, (rects >> 8) & 0xFF, (rects >> 16) & 0xFF, \
        (rects >> 24) & 0xFF
    for g in range(P):
        for d in range(min(D, (xmax[g] - xmin[g]) * (ymax[g] - ymin[g]))):
            if emap[g, d] < 0:
                continue
            r, k = divmod(int(emap[g, d]), K)
            for sq in range(S):
                if k < tops[r * S + sq]:
                    out[g] += partial[r * S + sq, k]
    return out


def test_two_stage_sum_matches_the_plain_vjp():
    P, width, height, tile, K, D = 512, 96, 64, 32, 128, 8
    cfg = RasterizeConfig(tile=tile, max_per_tile=K, max_tiles_per_gaussian=D)
    prep = make_prep(2, P, width, height, (2, 20), 0.1)
    bins = binning.bin_gaussians(prep, width, height, cfg)
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    payload = make_payload(prep, t(rng.uniform(0.2, 0.9, P)), t(rng.uniform(size=(P, 3))),
                           t(rng.normal(size=(P, 3))))
    tiles_x, tiles_y = binning.tile_grid(width, height, tile)
    T, npix = tiles_x * tiles_y, tile * tile
    g_values = t(rng.normal(size=(T, npix, composite_cuda.NCH)))
    g_final_t = t(rng.normal(size=(T, npix)))
    ref = composite_cuda.composite_vjp_plain(payload, bins.tile_index, bins.tile_counts,
                                             tiles_x, tiles_y, cfg, P, g_values,
                                             g_final_t).numpy()

    # stage 1 by autograd: the gradient of the gathered [T, K, 13] rows at
    # the cotangents of one (square, warp) patch of every tile at a time
    group = pixel_group(tile)
    S = squares(tile)
    warps = group.max() // S + 1
    px, py = composite.tile_pixel_coords(tiles_x, tiles_y, tile)
    per_group = []
    for gi in range(S * warps):
        gathered = payload[bins.tile_index.long()].detach().requires_grad_()
        out = composite.composite_tiles(gathered[..., 0:2], gathered[..., 2:5],
                                        gathered[..., 5], gathered[..., 6:13], px, py, cfg)
        mask = torch.from_numpy(group == gi)
        grad, = torch.autograd.grad((out.values, out.final_t), gathered,
                                    (g_values * mask[None, :, None], g_final_t * mask[None]))
        per_group.append(grad.numpy())

    def block(b):   # block b = row * S + square: its warps' sums, warp 0 first
        r, sq = divmod(b, S)
        acc = np.zeros((K, composite_cuda.NPAY), np.float32)
        for w in range(warps):
            acc += per_group[sq * warps + w][r]
        return acc

    emap = entry_map(bins.tile_index.numpy(), bins.rects.numpy(), P, 0, T, tiles_x, K, D)
    tops = np.repeat(bins.tile_counts.numpy(), S)   # each block's start: its row's count
    got = two_stage(block, range(T * S), T, S, K, P, D, emap, tops, bins.rects.numpy())
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-30)
    assert (np.abs(got - ref) / scale).max() <= SUM_TOL
    assert np.abs(ref[:P]).sum() > 0 and not got[P].any()
    shuffled = two_stage(block, rng.permutation(T * S), T, S, K, P, D, emap, tops,
                         bins.rects.numpy())
    assert np.array_equal(shuffled.view(np.int32), got.view(np.int32))


def test_constants_match_the_kernel():
    math_src = (CSRC / "composite_math.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", math_src))
    assert (int(consts["kSquare"]), int(consts["kPatchW"]), int(consts["kPatchH"])) == (
        SQUARE, PATCH_W, PATCH_H)
    src = (CSRC / "composite_bwd.cu").read_text()
    batch = int(re.search(r"constexpr int kBatch = (\d+);", src).group(1))
    # the entry map's decoding and the rect layout are binning.pack_rect's
    for line in ("const int xmin = rect & 0xFF, xmax = (rect >> 8) & 0xFF;",
                 "const int ymin = (rect >> 16) & 0xFF, ymax = (rect >> 24) & 0xFF;",
                 "const int d = (ty - ymin) * (xmax - xmin) + (tx - xmin);",
                 "if (d < D) map[(size_t)g * D + d] = (int)i;",
                 "const int n = min(D, (((rect >> 8) & 0xFF) - (rect & 0xFF)) *",
                 "(((rect >> 24) & 0xFF) - ((rect >> 16) & 0xFF)));",
                 "for (int d = 0; d < n; ++d) {", "for (int sq = 0; sq < squares; ++sq) {",
                 "const int w = __ffs(who) - 1;  // the lowest warp left: warps in ascending order",
                 "for (unsigned who = s_who[i / SDPGS_NPAY]; who != 0u; who &= who - 1u) {"):
        assert line in src, line
    packed = binning.pack_rect(*(torch.tensor([v], dtype=torch.int32) for v in (3, 200, 7, 130)))
    assert [int(v) for v in binning.unpack_rect(packed)] == [3, 200, 7, 130]
    # the Python side's blocks per tile are the kernel's
    assert composite_cuda.SQUARE == SQUARE
    assert [composite_cuda.squares(t) for t in (8, 16, 24, 32)] == [
        squares(t) for t in (8, 16, 24, 32)] == [1, 1, 1, 4]
    # smem_bytes for the largest block (a 24x24 tile: 18 warps), which both
    # instances opt in to, fits the card
    rows, cols, lanes = map(int, re.search(
        r"constexpr int kMaxBlockWarps = (\d+) \* (\d+) / (\d+);", src).groups())
    assert rows * cols // lanes == 18
    for warps in (2, 8, 18):
        smem = batch * (16 + 4 * 13 + 4 + 4 + 4 * 13 * warps)
        assert smem <= SMEM_LIMIT, (warps, smem)
