// K6: the reprojection z-buffer (forward warp with a scatter-min).
//
// Replaces sdpgs_tpu/ops/warp_pallas.py:_zbuf_kernel (pl.pallas_call at
// :115, reached through warp_zbuffer_batch from
// losses/depth.py:reproject_fused_depth_batch). For every (pseudo camera b,
// train view v) pair it forward-warps the train view's depth into the
// pseudo view and keeps, per destination pixel, the nearest z (0 = hole).
//
// Semantics (losses/depth.py:warp_depth_to_view): a source pixel (y, x)
// with depth d projects to X = [proj | c] (x, y, 1, 1/d) d, that is
// X_r = (P_r0 x + P_r1 y + P_r2) d + c_r, with proj = (K R_b)(K R_v)^-1 and
// c = K (t_b - R_b R_v^T t_v), computed once per pair by the wrapper. Then
// z = X_2, u = rint(X_0 / z), v = rint(X_1 / z) (half to even, as
// jnp.round), and the row is valid when 0 <= u < W, 0 <= v < H, z > 0 and
// d > 0. Valid rows scatter-min z into out[pair, v, u]. The TPU kernel's
// displacement window and packed codes are not carried over: every row
// scatters, so the result is the exact scatter-min and there are no
// outliers.
//
// Bound on the H100: bytes. The output ([n, H, W] f32, 146 MB at the
// prefetch's 64 x 3 pairs of 504x378) written once and the depths (2.3 MB)
// read once: 148 MB, 0.0444 ms at 3.35 TB/s.
//
// The first port made three passes over the output: a +inf fill, a
// scatter of one thread per row with a global atomicMin, and a pass that
// turned +inf into 0. The z-buffers do not fit in the 50 MB L2, so each
// pass went to HBM (about 730 MB in all) and the 36.6 M atomics to L2:
// 0.4145 ms, 9.3x the bound.
//
// Design, the cluster path (every shape whose pair fits one cluster's
// shared memory; ops/warp.py:zbuf_plan picks it from the shape alone):
// one thread-block cluster per pair, of c blocks, each owning rows =
// ceil(H / c) destination rows in rows x W x 4 bytes of dynamic shared
// memory. c is the smallest power of two whose blocks fit two to an SM,
// else one to an SM (8 blocks of 48 rows, 96,768 bytes, at 504x378; 16 of
// 48, 193,536 bytes, at 1008x756). Block r
//  (1) fills its band with +inf bits in shared memory; cluster.sync();
//  (2) projects the source rows of its own band, [r rows, (r + 1) rows),
//      and atomicMin's each valid row's z bits into the band that owns
//      its destination row: its own shared memory when v falls in its
//      band, else the owner's through map_shared_rank (distributed shared
//      memory); cluster.sync(), after which no block touches another's
//      memory, so none exits while a remote atomic may still reach it;
//  (3) writes its band once, 16-byte stores (W divisible by 4; 4-byte
//      stores otherwise), +inf turned into 0.
// The fill and the atomics never leave the SMs: the output is written once
// and the depths read once. A block projects its own band because the LLFF
// pseudo cameras move a row by a few rows, so nearly every atomic stays in
// the block (the smoke prints the share); correctness does not depend on
// it. A thread walks one column down its band, so the products P_r0 x are
// taken once a column, and loads kBatch rows' depths before it projects
// any. One cluster per pair, no persistent loop: two blocks of two pairs
// share an SM, so one block's write-out overlaps the other's scatter, and
// the block scheduler starts the next cluster as a band is written. Blocks
// have 1024 / (blocks an SM holds) threads, so an SM holds 32 warps.
//
// The general path (a pair larger than any cluster's shared memory, such
// as 4032x3024): the first port's three kernels over device memory.
//
// Both paths project a row with project_row, the plain version's
// association order, each product and sum rounded once (the file is built
// with -fmad=false), IEEE division and rintf, and the bounds test on the
// rounded floats. z > 0 on every valid row, so its IEEE bits order as
// int32 and an int atomicMin over +inf bits is the scatter-min; min is
// order-free, so both paths are bit-identical to the plain version.
//
// Measured (chip_smoke.py's K6 row and probes, 192 pairs; NVIDIA H100
// 80GB HBM3, 700 W; medians of three runs, PERF.md §6): at 504x378 this
// design 0.1508 ms, 3.4x the bound, against the first port's 0.4142. The
// probes there: 4 blocks of 95 rows (one an SM) 0.1732; 7 of 54 (32
// clusters resident on 112 SMs, against 30 of 8 on 120) 0.1630; 16 of 24
// (four an SM) 0.1559; the three kernels over chunks of 33 pairs, whose
// 25 MB stay in L2, 0.4165, no faster than over all pairs (0.4140). At
// 1008x756 the plan's 16 blocks of 48 rows take 0.7350 against the
// general path's 1.6085 (1.6620 by chunks of 9 pairs); no cluster of 8
// fits there. Measured with variants since removed from this file: source
// rows strided over the cluster instead of banded took 1.8x (4 blocks)
// and 2.5x (8 blocks) the banded time, most atomics remote; the cluster
// with no row projected, the fill and the write-out alone, took about
// 0.06 ms: the rest of the time is the rows' arithmetic (two IEEE
// divisions a row, 36.6 M rows), not memory. 53 registers, no spill (the
// general path: 22, 8 and 8).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// Mirrored in ops/warp.py (zbuf_plan) and checked against it by
// tests/test_torch_warp_plan.py.
constexpr int kInfBits = 0x7f800000;      // +inf: the fill, and a hole on write-out
constexpr int kMaxSmemBytes = 232448;     // dynamic shared memory a block may opt in to
constexpr int kPortableCluster = 8;       // larger clusters need the non-portable opt-in
constexpr int kMaxCluster = 16;           // the largest cluster the H100 schedules
constexpr int kSmemPerSm = 233472;        // shared memory an SM hands out (228 KB)
constexpr int kSmemReserved = 1024;       // taken by the runtime from each block
// Not mirrored.
constexpr int kWarpsPerSm = 32;
constexpr int kBatch = 4;                 // source rows a thread loads before projecting
constexpr int kThreads = 256;             // the general path

// An integer-valued float in [0, 2^23) as an int: u + 2^23 holds u in its
// low mantissa bits. An add, where a conversion would take the SM's
// quarter-rate conversion pipe.
SDPGS_DEVICE int small_int(float u) { return __float_as_int(u + 8388608.0f) - 0x4b000000; }

// One source row of a pair: whether it is valid and, if so, its
// destination pixel and z. m is the pair's [proj | c] rows and xr the
// product m[4 r] x (P_r0 x), which a caller may compute once per column.
SDPGS_DEVICE bool project_row(const float* m, float x0, float x1, float x2, float y, float d,
                              int H, int W, int& ui, int& vi, float& z) {
  // (P_r0 x + P_r1 y + P_r2) d + c_r, each product and sum rounded once
  const float X0 = (x0 + m[1] * y + m[2]) * d + m[3];
  const float X1 = (x1 + m[5] * y + m[6]) * d + m[7];
  z = (x2 + m[9] * y + m[10]) * d + m[11];
  const float u = rintf(X0 / z);
  const float v = rintf(X1 / z);
  // the bounds test on the rounded floats: equal to JAX's test on the
  // int32 casts, and no float-to-int conversion of an out-of-range value
  if (!(u >= 0.0f && u < (float)W && v >= 0.0f && v < (float)H && z > 0.0f && d > 0.0f))
    return false;
  ui = small_int(u);
  vi = small_int(v);
  return true;
}

// ---- the cluster path --------------------------------------------------

__global__ void __launch_bounds__(1024)
zbuf_cluster_kernel(const float* __restrict__ depths, const float* __restrict__ pc,
                    int* __restrict__ out, int V, int H, int W, int rows) {
  extern __shared__ int4 band4[];
  int* band = reinterpret_cast<int*>(band4);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / c;
  const int words = rows * W;

  // (1) this block's band of the pair's z-buffer: +inf bits
  const int4 inf4 = make_int4(kInfBits, kInfBits, kInfBits, kInfBits);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) band4[i] = inf4;
  for (int i = words / 4 * 4 + threadIdx.x; i < words; i += blockDim.x) band[i] = kInfBits;
  float m[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) m[j] = __ldg(pc + (size_t)pair * 12 + j);
  const float* dep = depths + (size_t)(pair % V) * H * W;
  cluster.sync();   // every band filled before any atomic reaches it

  // (2) the source rows of this block: its own band, each row's z into
  // the band that owns its destination row v
  const int lo = rank * rows;   // this block's rows [lo, lo + rows), source and destination
  const int nrows = min(rows, H - lo);
  // Thread t walks column x = t mod cols (then x + cols, ...) down the
  // rows lo + k, k = g, g + groups, ... (g = t / cols) of its band:
  // a warp's lanes read neighbouring pixels of one row, and a column's
  // products P_r0 x are taken once. It loads kBatch rows' depths before it
  // projects any, so that several loads are in flight. x and y are kept as
  // floats too (exact integers), with no conversion a row.
  const int cols = min(W, (int)blockDim.x);
  const int groups = blockDim.x / cols;
  const int g = threadIdx.x / cols;
  const int kstep = groups * kBatch;
  const float ystepf = (float)groups;
  for (int x = threadIdx.x % cols; g < groups && x < W; x += cols) {
    const float xf = (float)x;
    const float x0 = m[0] * xf, x1 = m[4] * xf, x2 = m[8] * xf;
    float yk = (float)(lo + g);
    for (int k = g; k < nrows; k += kstep) {
      float d[kBatch], yb[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int kj = k + j * groups;
        d[j] = kj < nrows ? dep[(lo + kj) * W + x] : 0.0f;   // d = 0: not a valid row
        yb[j] = yk;
        yk += ystepf;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        int ui, vi;
        float z;
        if (!project_row(m, x0, x1, x2, yb[j], d[j], H, W, ui, vi, z)) continue;
        const int bits = __float_as_int(z);
        const int local = vi - lo;
        if ((unsigned)local < (unsigned)rows) {
          atomicMin(band + local * W + ui, bits);
        } else {
          const int owner = vi / rows;
          atomicMin(cluster.map_shared_rank(band, owner) + (vi - owner * rows) * W + ui, bits);
        }
      }
    }
  }
  cluster.sync();   // every atomic done; from here a block reads only its own band

  // (3) the band's rows inside the image, written once, +inf -> 0
  const int here = max(min(rows, H - lo), 0) * W;
  int* dst = out + (size_t)pair * H * W + (size_t)lo * W;
  if ((W & 3) == 0) {   // then the band starts 16-byte aligned
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < here / 4; i += blockDim.x) {
      int4 q = band4[i];
      q.x = q.x == kInfBits ? 0 : q.x;
      q.y = q.y == kInfBits ? 0 : q.y;
      q.z = q.z == kInfBits ? 0 : q.z;
      q.w = q.w == kInfBits ? 0 : q.w;
      dst4[i] = q;
    }
  } else {
    for (int i = threadIdx.x; i < here; i += blockDim.x) {
      const int b = band[i];
      dst[i] = b == kInfBits ? 0 : b;
    }
  }
}

// The launch configuration of a cluster of c blocks of `rows` rows of
// width W; attrs must outlive cfg.
cudaError_t cluster_config(int c, int rows, int W, int n_pairs, cudaStream_t s,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attrs) {
  if (c < 1 || c > kMaxCluster || rows < 1 || (long long)rows * W * 4 > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const int smem = rows * W * 4;
  cudaError_t err = cudaFuncSetAttribute(zbuf_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (c > kPortableCluster) {
    err = cudaFuncSetAttribute(zbuf_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int per_sm = max(1, min(kSmemPerSm / (smem + kSmemReserved), kWarpsPerSm));
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(c * n_pairs));
  cfg.blockDim = dim3((unsigned)(kWarpsPerSm / per_sm * 32));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = (unsigned)c;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// ---- the general path --------------------------------------------------

__global__ void __launch_bounds__(kThreads)
fill_kernel(int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = kInfBits;
}

__global__ void __launch_bounds__(kThreads)
zbuf_kernel(const float* __restrict__ depths, const float* __restrict__ pc,
            int* __restrict__ out, int V, int H, int W) {
  __shared__ float m[12];
  const int pair = blockIdx.y;
  if (threadIdx.x < 12) m[threadIdx.x] = pc[pair * 12 + threadIdx.x];
  __syncthreads();
  const int npix = H * W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const float x = (float)(i % W);
  int ui, vi;
  float z;
  if (!project_row(m, m[0] * x, m[4] * x, m[8] * x, (float)(i / W),
                   depths[(size_t)(pair % V) * npix + i], H, W, ui, vi, z))
    return;
  atomicMin(out + (size_t)pair * npix + (size_t)vi * W + ui, __float_as_int(z));
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && out[i] == kInfBits) out[i] = 0;  // the bits of 0.0f
}

}  // namespace

// Clusters of c blocks of `rows` rows of width W that the device holds at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
SDPGS_API int sdpgs_warp_zbuf_clusters(int c, int rows, int W) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[1];
  cudaError_t err = cluster_config(c, rows, W, 1, nullptr, cfg, attrs);
  int active = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, zbuf_cluster_kernel, &cfg);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

// depths [V, H, W] f32; pc [n_pairs, 12] f32, pair p = b * V + v holding
// [proj | c] row-major (proj_r0, proj_r1, proj_r2, c_r for r = 0, 1, 2);
// out [n_pairs, H, W] f32, written whole (0 = hole). cluster > 0: the
// cluster path, `cluster` blocks of `rows` destination rows a pair
// (ops/warp.py:zbuf_plan). cluster == 0: the general path.
SDPGS_API int sdpgs_warp_zbuf(const float* depths, const float* pc, float* out, int n_pairs,
                              int V, int H, int W, int cluster, int rows, void* stream) {
  const long long n = (long long)n_pairs * H * W;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bits = reinterpret_cast<int*>(out);
  if (cluster > 0) {
    if ((long long)cluster * rows < H) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[1];
    cudaError_t err = cluster_config(cluster, rows, W, n_pairs, s, cfg, attrs);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, zbuf_cluster_kernel, depths, pc, bits, V, H, W, rows);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const unsigned flat_blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fill_kernel<<<flat_blocks, kThreads, 0, s>>>(bits, n);
  dim3 grid((H * W + kThreads - 1) / kThreads, n_pairs);
  zbuf_kernel<<<grid, kThreads, 0, s>>>(depths, pc, bits, V, H, W);
  finalize_kernel<<<flat_blocks, kThreads, 0, s>>>(bits, n);
  return static_cast<int>(cudaGetLastError());
}
