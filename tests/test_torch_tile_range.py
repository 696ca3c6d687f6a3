"""The tile range of the port's binning, compositing and rasterizer (the
plain versions of K2, K3 and K5 with a tile offset) against sdpgs_tpu.

A tile-sharded render splits a view's T tiles into n shards of
n_local = ceil(T / n) tiles, shard i taking the tiles from t0 = i n_local;
the last shards may run past the grid. The table rows, counts, overflow,
clipped and num_entries of ``bin_gaussians(tile_range=...)`` must equal
JAX's exactly for 1, 2, 3, 4 and 7 shards (a shard wholly past the grid
included), and the shards' rows must be the whole table's. The composited
rows of each shard must equal the whole render's rows bit for bit, rows
past the grid 0 with final transmittance 1, and the shards' payload
gradients must sum to the whole one (to 1e-6 of its largest entry: the
sums are taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.config import RasterizeConfig as JConfig
from sdpgs_tpu.ops.rasterize import binning as jbin
from sdpgs_tpu.ops.rasterize import composite_xla as jcomp
from sdpgs_tpu.ops.rasterize.preprocess import Preprocessed as JPrep
from sdpgs_torch.config import RasterizeConfig as TConfig
from sdpgs_torch.core.camera import Camera
from sdpgs_torch.core.gaussians import Gaussians
from sdpgs_torch.ops.rasterize import binning as tbin
from sdpgs_torch.ops.rasterize import composite as tcomp
from sdpgs_torch.ops.rasterize import composite_cuda, rasterizer
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed as TPrep
from sdpgs_torch.ops.rasterize.preprocess_cuda import preprocess_payload
from test_torch_binning import CASES, make_prep
from test_torch_core import random_arrays

SHARDS = (1, 2, 3, 4, 7)


def shard_ranges(num_tiles: int, n: int):
    n_local = -(-num_tiles // n)
    return [(i * n_local, n_local) for i in range(n)]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", ["ragged_grid", "d_clipping", "k_overflow"])
def test_table_range_matches_jax(case, n):
    P, width, height, tile, K, D, rr, dead = CASES[case]
    prep = make_prep(1, P, width, height, rr, dead)
    kw = dict(tile=tile, max_per_tile=K, max_tiles_per_gaussian=D, chunk=16)
    jprep = JPrep(**{k: jnp.asarray(v) for k, v in prep.items()})
    tprep = TPrep(**{k: torch.from_numpy(v) for k, v in prep.items()})
    whole = tbin.bin_gaussians(tprep, width, height, TConfig(**kw))
    tiles_x, tiles_y = tbin.tile_grid(width, height, tile)
    num_tiles = tiles_x * tiles_y
    n_local = -(-num_tiles // n)
    jcfg = JConfig(**kw, use_rank_kernel=False)
    jax_bin = jax.jit(lambda t0: jbin.bin_gaussians(jprep, width, height, jcfg,
                                                    tile_range=(t0, n_local)))
    rows, overflow = [], 0
    for t0, _ in shard_ranges(num_tiles, n):
        j = jax_bin(jnp.int32(t0))
        t = tbin.bin_gaussians(tprep, width, height, TConfig(**kw), tile_range=(t0, n_local))
        for name in ("tile_index", "tile_counts", "overflow", "clipped", "num_entries"):
            got, ref = getattr(t, name).numpy(), np.asarray(getattr(j, name))
            assert got.dtype == np.int32, name
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} t0={t0}")
        assert t.tile_index.shape == (n_local, K)
        past = max(0, min(n_local, t0 + n_local - num_tiles))
        if past:   # rows past the grid: empty
            assert not t.tile_counts[n_local - past:].any()
            assert (t.tile_index[n_local - past:] == P).all()
        rows.append(t.tile_index[:n_local - past])
        overflow += int(t.overflow)
        assert int(t.clipped) == int(whole.clipped)
        assert int(t.num_entries) == int(whole.num_entries)
    np.testing.assert_array_equal(torch.cat(rows).numpy(), whole.tile_index.numpy())
    assert overflow == int(whole.overflow)
    if case == "k_overflow":
        assert overflow > 0
    if case == "d_clipping":
        assert int(whole.clipped) > 0


@pytest.mark.parametrize("t0,n_local,tiles_x", [(0, 6, 6), (5, 4, 6), (21, 4, 6), (24, 3, 5)])
def test_tile_pixel_coords_range_matches_jax(t0, n_local, tiles_x):
    jx, jy = jcomp.tile_pixel_coords_range(jnp.int32(t0), n_local, tiles_x, 16)
    tx, ty = tcomp.tile_pixel_coords_range(t0, n_local, tiles_x, 16)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    wx, wy = tcomp.tile_pixel_coords(tiles_x, 4, 16)
    inside = min(n_local, max(0, tiles_x * 4 - t0))
    np.testing.assert_array_equal(tx[:inside].numpy(), wx[t0:t0 + inside].numpy())
    np.testing.assert_array_equal(ty[:inside].numpy(), wy[t0:t0 + inside].numpy())


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    g = Gaussians.from_numpy(random_arrays(rng, P=192, n=160), device="cpu")
    cam = Camera.create(R=np.eye(3), T=np.array([0.05, -0.02, 0.0]), fovx=0.9, fovy=0.7,
                        width=72, height=56, device="cpu")
    cfg = TConfig(tile=16, max_per_tile=64, max_tiles_per_gaussian=8, chunk=32)
    with torch.no_grad():
        pay = preprocess_payload(g.xyz, g.get_scaling(), g.get_rotation(), g.features_dc,
                                 g.features_rest, g.alive, g.get_opacity()[:, 0],
                                 g.language_feature_normalized(), cam, 3, near=cfg.near,
                                 low_pass=cfg.low_pass)
    return dict(cam=cam, payload=pay, cfg=cfg, rng=rng)


@pytest.mark.parametrize("n", [2, 3, 7])
def test_rasterize_tiles_range_rows(scene, n):
    cam, pay, cfg = scene["cam"], scene["payload"], scene["cfg"]
    whole, whole_bins = rasterizer.rasterize_tiles(pay, cam, cfg)
    tiles_x, tiles_y = tbin.tile_grid(cam.width, cam.height, cfg.tile)
    num_tiles = tiles_x * tiles_y
    g_values = torch.from_numpy(scene["rng"].normal(size=tuple(whole.values.shape))
                                .astype(np.float32))
    g_final_t = torch.from_numpy(scene["rng"].normal(size=tuple(whole.final_t.shape))
                                 .astype(np.float32))
    payload = pay.rows
    d_whole = composite_cuda.composite_vjp_plain(
        payload, whole_bins.tile_index, whole_bins.tile_counts, tiles_x, tiles_y, cfg,
        payload.shape[0] - 1, g_values, g_final_t)
    d_sum = torch.zeros_like(d_whole)
    for t0, n_local in shard_ranges(num_tiles, n):
        out, bins = rasterizer.rasterize_tiles(pay, cam, cfg, tile_range=(t0, n_local))
        inside = max(0, min(n_local, num_tiles - t0))
        np.testing.assert_array_equal(out.values[:inside].numpy(),
                                      whole.values[t0:t0 + inside].numpy())
        np.testing.assert_array_equal(out.final_t[:inside].numpy(),
                                      whole.final_t[t0:t0 + inside].numpy())
        assert not out.values[inside:].any() and (out.final_t[inside:] == 1).all()
        pad = n_local - inside
        gv = torch.cat([g_values[t0:t0 + inside], torch.ones((pad,) + g_values.shape[1:])])
        gt = torch.cat([g_final_t[t0:t0 + inside], torch.ones((pad,) + g_final_t.shape[1:])])
        d_sum += composite_cuda.composite_vjp_plain(
            payload, bins.tile_index, bins.tile_counts, tiles_x, tiles_y, cfg,
            payload.shape[0] - 1, gv, gt, t0=t0)
    scale = float(d_whole.abs().max())
    assert scale > 0
    assert float((d_sum - d_whole).abs().max()) <= 1e-6 * scale
