"""Kernel K2's decomposition (csrc/binning.cu) mirrored in numpy: coverage
words (bit l of word w: sorted Gaussian 32 w + l's tile rect covers the
tile, only for words below ceil(n_valid / 32)), then per tile a scan of the
words' popcounts in rounds, each set bit's rank from its word's prefix, the
D cap's sentinel holes and the sentinel fill past min(total, K). The
mirror's table and totals must equal build_table_plain's and the JAX scan
path's (use_rank_kernel=False), with overflow and clipped, at K2's edge
shapes: n_valid 0, 1 and not a multiple of 32, every rect covering every
tile, D = 1, a tile-8 grid and the Trainer's ladder sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.config import RasterizeConfig as JConfig
from sdpgs_tpu.ops.rasterize import binning as jbin
from sdpgs_tpu.ops.rasterize.preprocess import Preprocessed as JPrep
from sdpgs_torch.config import RasterizeConfig as TConfig
from sdpgs_torch.ops.rasterize import binning as tbin
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed as TPrep

WORDS_PER_THREAD = 4   # binning.cu: kWordsPerThread
ROUND_THREADS = 2      # small, so the mirror's scan takes several rounds
UNWRITTEN = np.uint32(0xFFFFFFFF)   # scratch past the words (A) writes
# one compile per configuration: far cheaper than the scan path run eagerly
jax_bin_gaussians = jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3))

# name: (P, valid, width, height, tile, K, D, radius range)
CASES = {
    "n_valid_0": (300, 0, 96, 64, 16, 64, 8, (1, 12)),
    "n_valid_1": (300, 1, 96, 64, 16, 64, 8, (1, 12)),
    "n_valid_not_32": (300, 253, 96, 64, 16, 64, 8, (1, 12)),
    "every_tile_overflows": (300, 300, 96, 64, 16, 64, 8, (400, 500)),
    "d_1": (300, 300, 96, 64, 16, 64, 1, (1, 20)),
    "tile_8": (300, 290, 504, 378, 8, 64, 8, (1, 40)),
    "ladder": (300, 290, 504, 378, 32, 2048, 32, (1, 60)),
}


def make_prep(seed, P, n_valid, width, height, radius_range):
    rng = np.random.default_rng(seed)
    # centres inside the image: every valid Gaussian's rect is non-empty
    mean2d = np.stack([rng.uniform(0, width, P), rng.uniform(0, height, P)],
                      -1).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, P).astype(np.float32)
    valid = rng.permutation(P) < n_valid
    radius = np.where(valid, np.ceil(rng.uniform(*radius_range, P)), 0).astype(np.float32)
    conic = rng.uniform(0.01, 0.5, (P, 3)).astype(np.float32)
    return dict(valid=valid, mean2d=mean2d, depth=depth, conic=conic, radius=radius)


def unpack(packed):
    return tuple(((packed >> s) & 0xFF).astype(np.int64) for s in (0, 8, 16, 24))


def cover_words(packed_s, n_valid, num_tiles, tiles_x):
    """Launch (A): [num_tiles, words] u32; words past ceil(n_valid / 32)
    are left unwritten."""
    P = packed_s.shape[0]
    words = -(-P // (32 * WORDS_PER_THREAD)) * WORDS_PER_THREAD
    cover = np.full((num_tiles, words), UNWRITTEN, np.uint32)
    xmin, xmax, ymin, ymax = unpack(packed_s)
    t = np.arange(num_tiles)
    tx, ty = t % tiles_x, t // tiles_x
    for w in range(-(-n_valid // 32)):
        p = np.arange(32 * w, 32 * w + 32)
        inside = p < n_valid
        pc = np.minimum(p, P - 1)
        covers = (inside[None, :] & (tx[:, None] >= xmin[pc]) & (tx[:, None] < xmax[pc])
                  & (ty[:, None] >= ymin[pc]) & (ty[:, None] < ymax[pc]))   # [T, 32]
        cover[:, w] = (covers.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return cover


def table_from_words(cover, packed_s, order, n_valid, tiles_x, K, D):
    """Launch (B): per tile, rounds of ROUND_THREADS x 4 words, an exclusive
    scan of the threads' popcounts, ranks from each word's prefix, holes
    where d >= D, then the sentinel fill and the uncapped total."""
    P = packed_s.shape[0]
    num_tiles = cover.shape[0]
    used = -(-n_valid // 32)
    xmin, xmax, ymin, _ = unpack(packed_s)
    table = np.full((num_tiles, K), -1, np.int32)
    totals = np.zeros(num_tiles, np.int32)
    per_round = ROUND_THREADS * WORDS_PER_THREAD
    for t in range(num_tiles):
        tx, ty = t % tiles_x, t // tiles_x
        base = 0
        for w0 in range(0, used, per_round):
            wd = [cover[t, w] if w < used else np.uint32(0) for w in range(w0, w0 + per_round)]
            mine = [sum(int(np.bitwise_count(x)) for x in wd[i:i + WORDS_PER_THREAD])
                    for i in range(0, per_round, WORDS_PER_THREAD)]
            excl = np.cumsum([0] + mine[:-1])
            for th in range(ROUND_THREADS):
                rank = base + int(excl[th])
                for k in range(WORDS_PER_THREAD):
                    word = int(wd[th * WORDS_PER_THREAD + k])
                    wi = w0 + th * WORDS_PER_THREAD + k
                    while word and rank < K:
                        bit = (word & -word).bit_length() - 1
                        p = wi * 32 + bit
                        d = (ty - ymin[p]) * (xmax[p] - xmin[p]) + (tx - xmin[p])
                        table[t, rank] = order[p] if d < D else P
                        rank += 1
                        word &= word - 1
            base += sum(mine)
        table[t, min(base, K):] = P
        totals[t] = base
    assert (table >= 0).all()   # every slot written once, no fill before
    return table.reshape(-1), totals


@pytest.mark.parametrize("case", sorted(CASES))
def test_words_match_plain_and_scan_path(case):
    P, n_valid, width, height, tile, K, D, rr = CASES[case]
    prep = make_prep(7, P, n_valid, width, height, rr)
    cfg_kw = dict(tile=tile, max_per_tile=K, max_tiles_per_gaussian=D)
    tiles_x, tiles_y = tbin.tile_grid(width, height, tile)
    T = tiles_x * tiles_y
    t_prep = TPrep(**{k: torch.from_numpy(v) for k, v in prep.items()})
    packed_s, order, nv = tbin.sort_rects(t_prep, width, height, TConfig(**cfg_kw))
    assert int(nv) == n_valid
    p_np, o_np = packed_s.numpy(), order.numpy()
    cover = cover_words(p_np, n_valid, T, tiles_x)
    table, totals = table_from_words(cover, p_np, o_np, n_valid, tiles_x, K, D)

    table_p, totals_p = tbin.build_table_plain(packed_s, order, nv, T, tiles_x, K, D)
    np.testing.assert_array_equal(table, table_p.numpy())
    np.testing.assert_array_equal(totals, totals_p.numpy())

    j = jax_bin_gaussians(JPrep(**{k: jnp.asarray(v) for k, v in prep.items()}), width, height,
                          JConfig(**cfg_kw, chunk=16, use_rank_kernel=False))
    xmin, xmax, ymin, ymax = unpack(p_np)
    clipped = np.maximum((xmax - xmin) * (ymax - ymin) - D, 0).sum()
    np.testing.assert_array_equal(table.reshape(T, K), np.asarray(j.tile_index))
    np.testing.assert_array_equal(np.minimum(totals, K), np.asarray(j.tile_counts))
    assert int(np.maximum(totals - K, 0).sum()) == int(j.overflow)
    assert clipped == int(j.clipped)

    # the cases reach what they are for
    live = np.arange(K)[None, :] < np.minimum(totals, K)[:, None]
    holes = int((table.reshape(T, K)[live] == P).sum())
    if case == "n_valid_0":
        assert (totals == 0).all() and (table == P).all()
    if case == "every_tile_overflows":
        assert (totals == n_valid).all() and (totals > K).all()
    if case == "d_1":
        assert clipped > 0 and holes > 0
    if case in ("n_valid_not_32", "tile_8", "ladder"):
        assert n_valid % 32 and totals.max() > 0
