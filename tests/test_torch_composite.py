"""The port's compositing (plain version of kernel K3) against sdpgs_tpu's
composite_tiles_xla and composite_tiles_pallas (interpret mode), at the
tolerances of tests/test_rasterizer.py: 2e-5 on color and alpha, 2e-4 on
depth and feature (transmittance is formed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.config import RasterizeConfig as JConfig
from sdpgs_tpu.ops.rasterize import composite_xla as jcomp
from sdpgs_tpu.ops.rasterize.composite_pallas import composite_tiles_pallas
from sdpgs_torch import _kernels
from sdpgs_torch.config import RasterizeConfig as TConfig
from sdpgs_torch.ops.rasterize import composite as tcomp
from sdpgs_torch.ops.rasterize import composite_cuda

TILE, TX, TY, K = 16, 3, 2, 128
KW = dict(tile=TILE, max_per_tile=K, chunk=32)


def make_payload(rng, P=300):
    """[P+1, 13] payload rows around the tile grid plus a [T, K] table with
    per-tile counts (sentinel P past each count)."""
    W, H = TX * TILE, TY * TILE
    pay = np.zeros((P + 1, 13), np.float32)
    pay[:P, 0] = rng.uniform(-4, W + 4, P)
    pay[:P, 1] = rng.uniform(-4, H + 4, P)
    pay[:P, 2] = rng.uniform(0.02, 0.3, P)          # conic a
    pay[:P, 3] = rng.uniform(-0.01, 0.01, P)        # conic b
    pay[:P, 4] = rng.uniform(0.02, 0.3, P)          # conic c
    pay[:P, 5] = rng.uniform(0.3, 0.99, P)          # opacity
    pay[:P, 6:9] = rng.uniform(size=(P, 3))         # rgb
    pay[:P, 9] = rng.uniform(1, 6, P)               # depth
    pay[:P, 10:13] = rng.normal(size=(P, 3))        # feature
    T = TX * TY
    counts = rng.integers(K // 4, K + 1, T).astype(np.int32)
    counts[0] = K
    table = np.full((T, K), P, np.int32)
    for t in range(T):
        table[t, :counts[t]] = rng.choice(P, counts[t], replace=False)
    table[1, 5] = P                                   # a sentinel hole
    return pay, table, counts


def gathered(pay, table):
    g = pay[table]
    return g[..., 0:2], g[..., 2:5], g[..., 5], g[..., 6:13]


def assert_close(values, final_t, ref_values, ref_final_t):
    np.testing.assert_allclose(values[..., :3], ref_values[..., :3], atol=2e-5, rtol=0)
    np.testing.assert_allclose(final_t, ref_final_t, atol=2e-5, rtol=0)
    np.testing.assert_allclose(values[..., 3:], ref_values[..., 3:], atol=2e-4, rtol=0)


def test_matches_xla(rng):
    pay, table, counts = make_payload(rng)
    px, py = jcomp.tile_pixel_coords(TX, TY, TILE)
    ref = jcomp.composite_tiles_xla(*(jnp.asarray(a) for a in gathered(pay, table)),
                                    px, py, JConfig(**KW))
    tpx, tpy = tcomp.tile_pixel_coords(TX, TY, TILE)
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(px))
    np.testing.assert_array_equal(tpy.numpy(), np.asarray(py))
    got = tcomp.composite_tiles(*(torch.from_numpy(a) for a in gathered(pay, table)),
                                tpx, tpy, TConfig(**KW))
    assert_close(got.values.numpy(), got.final_t.numpy(), np.asarray(ref.values),
                 np.asarray(ref.final_t))
    assert float(got.final_t.min()) < 0.05        # some pixels saturate


def test_gather_wrapper_matches_pallas_interpret(rng):
    pay, table, counts = make_payload(rng)
    px, py = jcomp.tile_pixel_coords(TX, TY, TILE)
    ref = composite_tiles_pallas(*(jnp.asarray(a) for a in gathered(pay, table)), px, py,
                                 JConfig(**KW, chunk_pallas=128), counts=jnp.asarray(counts))
    _kernels.reset_counts()
    got = composite_cuda.composite_gather(torch.from_numpy(pay), torch.from_numpy(table),
                                          torch.from_numpy(counts), TX, TY, TConfig(**KW),
                                          pay.shape[0] - 1)
    assert _kernels.PLAIN_CALLS["composite"] == 1 and _kernels.LAUNCHES["composite"] == 0
    assert got.values.shape == (TX * TY, TILE * TILE, 7)
    assert_close(got.values.numpy(), got.final_t.numpy(), np.asarray(ref.values),
                 np.asarray(ref.final_t))


def test_gather_rejects_payload_without_sentinel_row(rng):
    """The table indexes rows up to the sentinel P: a payload of P rows
    (no zero row) is refused before anything reads it."""
    pay, table, counts = make_payload(rng)
    P = pay.shape[0] - 1
    args = (torch.from_numpy(table), torch.from_numpy(counts), TX, TY, TConfig(**KW), P)
    with pytest.raises(ValueError, match="sentinel"):
        composite_cuda.composite_gather(torch.from_numpy(pay[:P]), *args)
    with pytest.raises(ValueError, match="sentinel"):
        composite_cuda.composite_gather_plain(torch.from_numpy(pay[:P]), *args)


def test_rect_cutoff_matches_xla(rng):
    pay, table, _ = make_payload(rng)
    rect = rng.integers(0, 3, size=table.shape + (4,)).astype(np.float32)
    rect[..., 1] += rect[..., 0]
    rect[..., 3] += rect[..., 2]
    px, py = jcomp.tile_pixel_coords(TX, TY, TILE)
    ref = jcomp.composite_tiles_xla(*(jnp.asarray(a) for a in gathered(pay, table)),
                                    px, py, JConfig(**KW), rect=jnp.asarray(rect))
    tpx, tpy = tcomp.tile_pixel_coords(TX, TY, TILE)
    got = tcomp.composite_tiles(*(torch.from_numpy(a) for a in gathered(pay, table)),
                                tpx, tpy, TConfig(**KW), rect=torch.from_numpy(rect))
    assert_close(got.values.numpy(), got.final_t.numpy(), np.asarray(ref.values),
                 np.asarray(ref.final_t))


@pytest.mark.parametrize("shape", [(2, 3, 16, 20, 40), (1, 1, 32, 32, 32)])
def test_assemble_image_matches(rng, shape):
    tx, ty, tile, H, W = shape
    tiles = rng.normal(size=(tx * ty, tile * tile, 5)).astype(np.float32)
    ref = jcomp.assemble_image(jnp.asarray(tiles), tx, ty, tile, H, W)
    got = tcomp.assemble_image(torch.from_numpy(tiles), tx, ty, tile, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
