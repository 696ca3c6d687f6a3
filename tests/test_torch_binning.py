"""The port's binning (plain version of kernel K2) against sdpgs_tpu's
bin_gaussians on identical Preprocessed arrays: table, counts, overflow,
clipped and num_entries bit-identical, against the scan path and against
the three interpret-mode rank-kernel layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpgs_tpu.config import RasterizeConfig as JConfig
from sdpgs_tpu.ops.rasterize import binning as jbin
from sdpgs_tpu.ops.rasterize.preprocess import Preprocessed as JPrep
from sdpgs_torch import _kernels
from sdpgs_torch.config import RasterizeConfig as TConfig
from sdpgs_torch.ops.rasterize import binning as tbin
from sdpgs_torch.ops.rasterize.preprocess import Preprocessed as TPrep

# name: (P, width, height, tile, K, D, radius range, dead share)
CASES = {
    "drop_free": (512, 96, 64, 16, 256, 8, (1, 8), 0.1),
    "k_overflow": (512, 64, 48, 16, 16, 8, (2, 14), 0.1),
    "d_clipping": (512, 96, 64, 16, 256, 2, (8, 30), 0.1),
    "dead_slots": (512, 96, 64, 16, 256, 8, (1, 8), 0.6),
    "ragged_grid": (512, 90, 50, 16, 128, 8, (1, 8), 0.1),
}


def make_prep(seed, P, width, height, radius_range, dead):
    rng = np.random.default_rng(seed)
    mean2d = np.stack([rng.uniform(-10, width + 10, P),
                       rng.uniform(-10, height + 10, P)], -1).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, P).astype(np.float32)
    depth[:16] = depth[16]                      # ties: the stable sort decides
    valid = rng.random(P) > dead
    radius = np.where(valid, np.ceil(rng.uniform(*radius_range, P)), 0).astype(np.float32)
    conic = rng.uniform(0.01, 0.5, (P, 3)).astype(np.float32)
    return dict(valid=valid, mean2d=mean2d, depth=depth, conic=conic, radius=radius)


def run_both(prep, width, height, cfg_kw, jax_kw):
    j = jbin.bin_gaussians(JPrep(**{k: jnp.asarray(v) for k, v in prep.items()}),
                           width, height, JConfig(**cfg_kw, **jax_kw))
    t = tbin.bin_gaussians(TPrep(**{k: torch.from_numpy(v) for k, v in prep.items()}),
                           width, height, TConfig(**cfg_kw))
    return j, t


def assert_identical(j, t):
    for name in ("tile_index", "tile_counts", "overflow", "clipped", "num_entries"):
        got, ref = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_scan_path(case):
    P, width, height, tile, K, D, rr, dead = CASES[case]
    prep = make_prep(1, P, width, height, rr, dead)
    kw = dict(tile=tile, max_per_tile=K, max_tiles_per_gaussian=D, chunk=16)
    j, t = run_both(prep, width, height, kw, dict(use_rank_kernel=False))
    assert_identical(j, t)
    if case == "k_overflow":
        assert int(t.overflow) > 0
    if case == "d_clipping":
        assert int(t.clipped) > 0
        # a covering Gaussian whose entry the D cap cut leaves a sentinel hole
        live = np.arange(K)[None, :] < t.tile_counts.numpy()[:, None]
        assert (t.tile_index.numpy()[live] == P).any()
    if case == "drop_free":
        assert int(t.overflow) == 0 and int(t.clipped) == 0


@pytest.mark.parametrize("layout", [
    dict(rank_kernel_lanes=True, rank_block_slots=4096),
    dict(rank_kernel_lanes=False, rank_block_slots=4096),
    dict(rank_block_slots=0),
])
def test_matches_interpret_rank_kernels(layout):
    """K2 stands in for all three TPU layouts: the table is the same
    whatever rank_kernel_lanes / rank_block_slots say (drop-free S)."""
    P, width, height, tile, K, D, rr, dead = CASES["drop_free"]
    prep = make_prep(2, P, width, height, rr, dead)
    kw = dict(tile=tile, max_per_tile=K, max_tiles_per_gaussian=D, chunk=16)
    j, t = run_both(prep, width, height, kw,
                    dict(use_rank_kernel=True, interpret_kernels=True,
                         rank_block_gaussians=256, **layout))
    assert_identical(j, t)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    P, width, height, tile, K, D, rr, dead = CASES["drop_free"]
    prep = make_prep(3, P, width, height, rr, dead)
    _kernels.reset_counts()
    tbin.bin_gaussians(TPrep(**{k: torch.from_numpy(v) for k, v in prep.items()}),
                       width, height, TConfig(tile=tile, max_per_tile=K))
    assert _kernels.PLAIN_CALLS["binning"] == 1 and _kernels.LAUNCHES["binning"] == 0


def test_rect_packing_round_trips():
    rng = np.random.default_rng(4)
    r = [torch.from_numpy(rng.integers(0, 256, 100).astype(np.int32)) for _ in range(4)]
    packed = tbin.pack_rect(*r)
    assert torch.equal(packed, torch.from_numpy(np.array(
        jbin.pack_rect(*(jnp.asarray(x.numpy()) for x in r)))))
    for a, b in zip(tbin.unpack_rect(packed), r):
        assert torch.equal(a, b)
