"""K6's launch plan and its cluster partition (ops/warp.py:zbuf_plan,
csrc/warp_zbuf.cu), on the CPU, without JAX.

The cluster path gives each block of a pair's cluster one band of
destination rows in shared memory and the same band of source rows to
project. A plain simulation of that partition (source rows grouped by
band, each band's valid rows scatter-min'd into the band that owns their
destination row, the bands concatenated) must equal the plain z-buffer bit
for bit, on the test rig's 64x48 pairs cut into 4 bands of 12 rows."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdpgs_torch.ops import warp

KERNEL_SOURCE = Path(warp.__file__).resolve().parent.parent / "csrc" / "warp_zbuf.cu"
H, W = 48, 64
# the rig's pairs cut as a shared-memory limit of 12 rows a block would cut them
SMALL_PLAN = warp.ZbufPlan("cluster", 4, 12, 12 * W * 4)


def fits(H_, W_, c, limit):
    return -(-H_ // c) * W_ * 4 <= limit


def plan_bands(plan, H_):
    """Block r's rows [lo, hi) as the kernel's rank computes them: the
    destination rows it owns and, on the cluster path, the source rows it
    projects (empty past H). The general path is one band."""
    if plan.path == "general":
        return [(0, H_)]
    return [(min(r * plan.rows, H_), min((r + 1) * plan.rows, H_)) for r in range(plan.cluster)]


@pytest.mark.parametrize("H_, W_, path, cluster, rows", [
    (378, 504, "cluster", 8, 48),        # LLFF: two blocks an SM
    (756, 1008, "cluster", 16, 48),      # one block an SM, non-portable
    (377, 503, "cluster", 8, 48),        # odd sizes: 4-byte write-out
    (503, 377, "cluster", 8, 63),
    (2, 64, "cluster", 1, 2),
    (3, 30_000, "cluster", 4, 1),        # fewer rows than blocks: one band empty
    (3024, 4032, "general", 0, 3024),    # past every cluster
    (2, 60_000, "general", 0, 2),        # one row past a block's shared memory
])
def test_plan_places_every_row_once(H_, W_, path, cluster, rows):
    plan = warp.zbuf_plan(H_, W_)
    assert (plan.path, plan.cluster, plan.rows) == (path, cluster, rows)
    if path == "general":
        assert plan_bands(plan, H_) == [(0, H_)]
        assert not fits(H_, W_, warp.MAX_CLUSTER, warp.MAX_SMEM_BYTES)
        return
    assert plan.smem_bytes == plan.rows * W_ * 4 <= warp.MAX_SMEM_BYTES
    assert plan.cluster in warp.CLUSTER_SIZES and plan.cluster <= warp.MAX_CLUSTER
    # the first tier any cluster meets, and the smallest cluster in it
    tier = next(t for t in warp.SMEM_TIERS
                if any(fits(H_, W_, c, t) for c in warp.CLUSTER_SIZES))
    assert plan.smem_bytes <= tier
    assert not any(fits(H_, W_, c, tier) for c in warp.CLUSTER_SIZES if c < plan.cluster)
    bands = plan_bands(plan, H_)
    assert len(bands) == plan.cluster and bands[0][0] == 0
    # every source row in exactly one block's band
    src = np.zeros(H_, np.int64)
    for lo, hi in bands:
        src[lo:hi] += 1
    assert (src == 1).all()
    # every destination row owned by exactly one block: the kernel's
    # owner = v / rows, at offset v - owner * rows inside its band
    v = np.arange(H_)
    owner = v // plan.rows
    assert (owner < plan.cluster).all()
    lo = np.array([b[0] for b in bands])[owner]
    hi = np.array([b[1] for b in bands])[owner]
    assert ((lo <= v) & (v < hi)).all()
    assert ((v - owner * plan.rows) < plan.rows).all()
    if (H_, W_) == (378, 504):   # two blocks an SM: 2 x (96,768 + 1,024) <= 233,472
        assert plan.smem_bytes == 96_768
        assert 2 * (plan.smem_bytes + warp.BLOCK_RESERVED_BYTES) <= warp.SM_SMEM_BYTES


def simulate_cluster(depths, pc, plan):
    """The cluster path's partition in plain torch: [n, H, W] z-buffers and
    the share of valid rows whose destination stayed in their own band."""
    Vd, Hd, Wd = depths.shape
    n = pc.shape[0]
    u, v, z, valid = warp.project_rows(depths, pc)
    ui = torch.where(valid, u, 0).long()
    vi = torch.where(valid, v, 0).long()
    owner = vi // plan.rows
    ys = torch.arange(Hd * Wd) // Wd
    bands = [torch.full((n * plan.rows * Wd,), torch.inf) for _ in range(plan.cluster)]
    local = 0
    for r, (lo, hi) in enumerate(plan_bands(plan, Hd)):
        mine = valid & ((ys >= lo) & (ys < hi))[None]
        local += int((mine & (owner == r)).sum())
        for o in range(plan.cluster):
            sel = mine & (owner == o)
            pair = torch.nonzero(sel, as_tuple=True)[0]
            idx = pair * (plan.rows * Wd) + (vi[sel] - o * plan.rows) * Wd + ui[sel]
            bands[o].scatter_reduce_(0, idx, z[sel], reduce="amin")
    parts = [b.reshape(n, plan.rows, Wd)[:, :hi - lo]
             for b, (lo, hi) in zip(bands, plan_bands(plan, Hd))]
    out = torch.cat(parts, dim=1)
    return torch.where(torch.isinf(out), 0.0, out), local / max(int(valid.sum()), 1)


def single_pair(proj, c=(0.0, 0.0, 0.0)):
    rows = np.concatenate([np.asarray(proj, np.float32), np.asarray(c, np.float32)[:, None]], 1)
    return torch.from_numpy(rows.reshape(1, 12))


@pytest.mark.parametrize("case", ["rig", "crossing", "one_band", "collapse"])
def test_partition_simulation_equals_the_plain_zbuffer(rng, case):
    depths = torch.from_numpy(rng.uniform(2.0, 6.0, size=(3, H, W)).astype(np.float32))
    depths[0, :4, :4] = 0.0                          # holes in the source
    if case == "rig":   # tests/test_torch_warp.py's 4 pseudo cameras x 3 views
        K = torch.tensor([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
        R_t = torch.eye(3).expand(3, 3, 3)
        t_t = torch.tensor([[0.2 * (i - 1), 0.0, 0.0] for i in range(3)])
        R_p = torch.eye(3).expand(4, 3, 3)
        t_p = torch.tensor([[0.05 * i, 0.02 * i, 0.01] for i in range(4)])
        pc = warp.pair_rows(K, R_t, t_t, R_p, t_p)
    elif case == "crossing":   # v = H - 1 - y: band r lands in band 3 - r
        pc = single_pair([[1, 0, 0], [0, -1, H - 1], [0, 0, 1]])
    elif case == "one_band":   # v = rint(y / 5): every row lands in band 0
        pc = single_pair([[1, 0, 0], [0, 0.2, 0], [0, 0, 1]])
    else:                      # a handful of pixels on a band edge
        pc = single_pair([[4.0 / W, 0, 30], [0, 2.0 / H, 11], [0, 0, 1]])
    got, share = simulate_cluster(depths, pc, SMALL_PLAN)
    ref = warp.warp_zbuffer_rows_plain(depths, pc)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    filled = int((ref > 0).sum())
    print(f"{case}: {pc.shape[0]} pairs, filled {filled}, valid rows local to their "
          f"band {share:.3f}")
    assert filled > 0
    if case == "crossing":
        assert share == 0.0
    if case == "one_band":
        assert 0.2 < share < 0.3          # band 0's own rows of the 4 bands
        assert not bool((ref[:, 12:] > 0).any())
    if case == "collapse":
        assert filled <= 15


def test_constants_match_the_kernel():
    """zbuf_plan's mirror is the kernel's: the +inf bits, the shared memory
    of a block and of an SM and the cluster sizes."""
    src = KERNEL_SOURCE.read_text()
    consts = {k: int(v, 0) for k, v in re.findall(r"constexpr int (k\w+) = (0x[0-9a-f]+|\d+);",
                                                  src)}
    assert {k: consts[k] for k in ("kInfBits", "kMaxSmemBytes", "kSmemPerSm", "kSmemReserved",
                                   "kPortableCluster", "kMaxCluster")} == {
        "kInfBits": warp.INF_BITS, "kMaxSmemBytes": warp.MAX_SMEM_BYTES,
        "kSmemPerSm": warp.SM_SMEM_BYTES, "kSmemReserved": warp.BLOCK_RESERVED_BYTES,
        "kPortableCluster": warp.PORTABLE_CLUSTER, "kMaxCluster": warp.MAX_CLUSTER}
    assert int(np.float32(np.inf).view(np.int32)) == warp.INF_BITS
    # the kernel opts in to non-portable sizes above the portable limit
    assert "c > kPortableCluster" in src and "NonPortableClusterSizeAllowed" in src
