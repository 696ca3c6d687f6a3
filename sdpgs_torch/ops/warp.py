"""The reprojection z-buffer: forward-warp train depths into pseudo views.

Counterpart of ``sdpgs_tpu/ops/warp_pallas.py:140-240``. Every (pseudo
camera b, train view v) pair warps the train view's depth into the pseudo
view and keeps the nearest z per destination pixel (a scatter-min; 0 =
hole), as ``losses/depth.py:warp_depth_to_view`` does for one pair.

On CUDA tensors all pairs go through kernel K6 (``csrc/warp_zbuf.cu``) in
one call; on CPU tensors through :func:`warp_zbuffer_rows_plain`, the
projection in elementwise torch and ``scatter_reduce_(..., "amin")`` (JAX's
``.at[].min``). Both take the same per-pair ``[proj | c]`` rows and
evaluate them in the same association order, so their z-buffers are
bit-identical. The TPU kernel's displacement window is not carried over:
every row scatters, so the outlier counts are always 0.

K6 has two paths, chosen by :func:`zbuf_plan` from the shape alone: the
cluster path keeps each pair's z-buffer in the shared memory of one
thread-block cluster (every shape up to 16 blocks of 232,448 bytes, so
504x378 and 1008x756), the general path fills, scatters into and
finalizes the z-buffers in device memory (larger pairs, such as
4032x3024). Each wrapper call launches one path once and counts it in
``_kernels.WARP_PATH_LAUNCHES``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdpgs_torch import _kernels

# Mirrored from csrc/warp_zbuf.cu (tests/test_torch_warp_plan.py checks them).
INF_BITS = 0x7F800000          # kInfBits: +inf, the fill and a hole
MAX_SMEM_BYTES = 232_448       # kMaxSmemBytes: dynamic shared memory of one block
SM_SMEM_BYTES = 233_472        # kSmemPerSm: shared memory an SM hands out
BLOCK_RESERVED_BYTES = 1_024   # kSmemReserved: the runtime's share of each block
PORTABLE_CLUSTER = 8           # kPortableCluster: above it, the non-portable opt-in
MAX_CLUSTER = 16               # kMaxCluster: the largest cluster the H100 schedules
# A block's shared memory: first as much as lets two blocks share an SM
# (one block's write-out then overlaps the other's scatter), then as much
# as one block may have.
SMEM_TIERS = (SM_SMEM_BYTES // 2 - BLOCK_RESERVED_BYTES, MAX_SMEM_BYTES)
# Powers of two: the GPCs hold whole clusters of these best (at 504x378,
# two blocks an SM, the 30 resident clusters of 8 fill 120 SMs, the 32 of
# 7 fill 112, and 7 took 8% longer).
CLUSTER_SIZES = (1, 2, 4, 8, 16)


class ZbufPlan(NamedTuple):
    """K6's launch for one shape: ``path`` "cluster" with ``cluster`` blocks
    a pair, each owning ``rows`` destination rows and ``smem_bytes`` of
    shared memory, or "general" (cluster 0, rows H, no shared memory)."""
    path: str
    cluster: int
    rows: int
    smem_bytes: int


def zbuf_plan(H: int, W: int) -> ZbufPlan:
    """K6's path for [n, H, W] z-buffers, from the shape alone: the
    smallest cluster of CLUSTER_SIZES whose blocks each hold ceil(H / c)
    rows of a pair's z-buffer within the first of SMEM_TIERS (bytes a
    block) that any cluster meets, else the general path. At 504x378: 8
    blocks of 48 rows, 96,768 bytes each, two blocks an SM; at 1008x756:
    16 blocks of 48 rows, one an SM; at 4032x3024: the general path."""
    for limit in SMEM_TIERS:
        for c in CLUSTER_SIZES:
            rows = -(-H // c)
            if rows * W * 4 <= limit:
                return ZbufPlan("cluster", c, rows, rows * W * 4)
    return ZbufPlan("general", 0, H, 0)


def pair_rows(K, R_train, t_train, R_pseudo, t_pseudo) -> torch.Tensor:
    """[B * V, 12] f32: per pair (b, v), row-major b * V + v, the rows
    (proj_r0, proj_r1, proj_r2, c_r) for r = 0, 1, 2 of
    proj = (K R_b)(K R_v)^-1 and c = K (t_b - R_b R_v^T t_v)
    (warp_pallas.py:152-153)."""
    Rb, tb = R_pseudo[:, None], t_pseudo[:, None]            # [B, 1, ...]
    Rv, tv = R_train[None], t_train[None]                    # [1, V, ...]
    # inv_ex: no device sync to check for a singular matrix
    proj = (K @ Rb) @ torch.linalg.inv_ex(K @ Rv)[0]          # [B, V, 3, 3]
    c = K @ (tb - (Rb @ Rv.transpose(-1, -2) @ tv[..., None])[..., 0])[..., None]
    rows = torch.cat([proj, c], dim=-1)                       # [B, V, 3, 4]
    return rows.reshape(-1, 12).to(torch.float32).contiguous()


def project_rows(depths: torch.Tensor, pc: torch.Tensor):
    """The shared projection math (JAX ``project_rows``): for every pair's
    source pixels, flat (u, v, z, valid) of shape [n, H * W], u and v as
    rounded floats. Each pair p reads ``depths[p % V]``."""
    V, H, W = depths.shape
    n = pc.shape[0]
    dev = depths.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    x, y = xs.reshape(1, -1), ys.reshape(1, -1)
    d = depths.reshape(V, -1)[torch.arange(n, device=dev) % V]   # [n, HW]
    m = [pc[:, j:j + 1] for j in range(12)]

    def row(r):   # (P_r0 x + P_r1 y + P_r2) d + c_r, one rounding per op
        return (m[4 * r] * x + m[4 * r + 1] * y + m[4 * r + 2]) * d + m[4 * r + 3]

    X0, X1, z = row(0), row(1), row(2)
    u = torch.round(X0 / z)
    v = torch.round(X1 / z)
    valid = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0) & (d > 0)
    return u, v, z, valid


def scatter_rows(u, v, z, valid, H: int, W: int):
    """The (index, value) rows of the scatter-min over all pairs: index
    ``p * H * W + v * W + u``, or ``n * H * W`` (a dropped slot) for an
    invalid row."""
    n = u.shape[0]
    base = torch.arange(n, device=u.device, dtype=torch.int64)[:, None] * (H * W)
    ui = torch.where(valid, u, 0).to(torch.int64)
    vi = torch.where(valid, v, 0).to(torch.int64)
    idx = torch.where(valid, base + vi * W + ui, n * H * W)
    return idx.reshape(-1), torch.where(valid, z, torch.inf).reshape(-1)


def warp_zbuffer_rows_plain(depths: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: [n, H, W] f32 z-buffers (0 = hole)."""
    _kernels.plain_call("warp_zbuf")
    V, H, W = depths.shape
    n = pc.shape[0]
    idx, zv = scatter_rows(*project_rows(depths, pc), H, W)
    buf = torch.full((n * H * W + 1,), torch.inf, dtype=torch.float32, device=depths.device)
    buf.scatter_reduce_(0, idx, zv, reduce="amin")
    zbuf = buf[:-1].reshape(n, H, W)
    return torch.where(torch.isinf(zbuf), 0.0, zbuf)


def warp_zbuffer_rows(depths: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Kernel K6 on CUDA tensors, its plain version on CPU tensors.
    depths [V, H, W] f32; pc [n, 12] f32 from :func:`pair_rows`; returns
    [n, H, W] f32. The path is :func:`zbuf_plan`'s; a cluster that the
    device cannot hold raises (no retry on the other path)."""
    if not depths.is_cuda:
        return warp_zbuffer_rows_plain(depths, pc)
    V, H, W = depths.shape
    n = pc.shape[0]
    _kernels.check(depths, "depths", torch.float32, (V, H, W))
    _kernels.check(pc, "pc", torch.float32, (n, 12))
    plan = zbuf_plan(H, W)
    if plan.path == "cluster":
        active = _kernels.lib().sdpgs_warp_zbuf_clusters(plan.cluster, plan.rows, W)
        if active <= 0:
            raise RuntimeError(f"K6: the device holds no cluster of {plan.cluster} blocks with "
                               f"{plan.smem_bytes} bytes of shared memory each ({active})")
    out = torch.empty((n, H, W), dtype=torch.float32, device=depths.device)
    _kernels.launch("warp_zbuf", "sdpgs_warp_zbuf", _kernels.ptr(depths), _kernels.ptr(pc),
                    _kernels.ptr(out), n, V, H, W, plan.cluster, plan.rows,
                    _kernels.stream(depths.device))
    _kernels.WARP_PATH_LAUNCHES[plan.path] += 1
    return out


def warp_zbuffer_batch(train_depths, K, R_train, t_train, R_pseudo, t_pseudo):
    """All (pseudo camera, train view) warps at once.

    train_depths [V, H, W]; K [3, 3]; R_train [V, 3, 3], t_train [V, 3]
    (world -> camera); R_pseudo [B, 3, 3], t_pseudo [B, 3]. Returns
    (warped [B, V, H, W] f32 with 0 = hole, outliers [B] int32, always 0:
    every row scatters). The z-buffer carries no gradient: every caller in
    JAX stops it (losses/depth.py:197,254)."""
    V, H, W = train_depths.shape
    B = R_pseudo.shape[0]
    with torch.no_grad():
        pc = pair_rows(K, R_train, t_train, R_pseudo, t_pseudo)
        warped = warp_zbuffer_rows(train_depths.detach().contiguous(), pc).reshape(B, V, H, W)
    return warped, torch.zeros((B,), dtype=torch.int32, device=train_depths.device)
