"""The bench-shape sharded certification (parallel/certify_bench_shape.py)
on 2 gloo ranks on the CPU, at a reduced shape (64x48, capacity 1,024,
500 alive; the bench's K 1,024 and two views), on each 2-rank mesh: 2
sharded steps against one card's (loss and PSNR 1e-3 relative, telemetry
exact, the ``gauss`` split after every step) and one densify event with the
k-NN (the split after the slot surgery, alive within JAX's tolerance of
the single-card event). Its inputs are bench.py's draws: held against
``bench._make_inputs`` here."""

import numpy as np
import pytest
import torch

from sdpgs_torch.parallel import certify_bench_shape as cbs
from torch_ranks import RankPool
from torch_threads import few_threads  # noqa: F401  (autouse)

SHAPE = dict(width=64, height=48, capacity=1024, alive=500)
STEPS = 2
MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2))


def test_inputs_are_the_benchs(monkeypatch):
    import bench

    for k, v in dict(WIDTH=SHAPE["width"], HEIGHT=SHAPE["height"], CAPACITY=SHAPE["capacity"],
                     ALIVE=SHAPE["alive"], VIEWS=cbs.VIEWS).items():
        monkeypatch.setattr(bench, k, v)
    g_j, _, b_j = bench._make_inputs(np.random.default_rng(3))
    g_t, _, b_t = cbs.make_inputs(np.random.default_rng(3), device="cpu", **SHAPE)
    for name in ("xyz", "opacity", "scaling", "rotation", "features_dc", "alive"):
        np.testing.assert_array_equal(getattr(g_t, name).detach().numpy(),
                                      np.asarray(getattr(g_j, name)), err_msg=name)
    for name in ("image", "depth_mono", "feature", "seg_map"):
        np.testing.assert_array_equal(getattr(b_t, name).numpy(), np.asarray(getattr(b_j, name)))


def test_certify_bench_shape_two_ranks(tmp_path):
    pool = RankPool(2, tmp_path)
    try:
        ranks = pool.run("certify_bench_shape", MESHES, SHAPE, STEPS)
    finally:
        pool.close()
    for summary in ranks:
        assert summary["shape"] == dict(cbs.BENCH_SHAPE, **SHAPE) and summary["K"] == 1024
        assert summary["steps"] == STEPS
        assert set(summary["meshes"]) == set(MESHES)
        for res in summary["meshes"].values():
            np.testing.assert_allclose(res["loss"], summary["loss_single"], rtol=cbs.LOSS_RTOL)
    keys = ("loss_single", "alive_single")
    assert all(ranks[0][k] == ranks[1][k] for k in keys)
    assert all(ranks[0]["meshes"][m]["loss"] == ranks[1]["meshes"][m]["loss"] for m in MESHES)


def test_mesh_must_hold_the_ranks():
    with pytest.raises(AssertionError, match="process group"):
        cbs.certify_bench_shape(device="cpu")
