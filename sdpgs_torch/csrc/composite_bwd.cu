// K5: per-tile compositing, backward.
//
// Replaces sdpgs_tpu/ops/rasterize/composite_pallas.py:_bwd_kernel (the
// pl.pallas_call at :318, reached through the custom vjp of
// composite_tiles_pallas). From the cotangents of the 7 composited
// channels and of the final transmittance it forms the gradient of the
// packed [P+1, 13] payload (xy, conic abc, opacity*valid, rgb, depth,
// feature) that K3 gathered, in the suffix form of composite_pallas.py:21-27:
//   dL/dv_i = w_i g,  dL/dalpha_i = T_i (v_i . g) - S_i / (1 - alpha_i),
//   S_i = sum_{j>i} w_j (v_j . g) + T_final g_T,
// then power -> (xy, conic) and alpha -> opacity (composite_math.cuh).
//
// Bound on the H100: the bytes of its inputs and output, or f32
// arithmetic on the CUDA cores, whichever is longer (the fixed order's
// scratch, below, moves more bytes than the function needs). The function needs,
// for each contributing (entry, pixel) pair, the alpha test (~16
// operations with one exp) and the gradient with its sum into the
// entry's row (~61); on the LLFF train-step inputs 4.3% of the pairs up
// to each pixel's last contributor (K3's last_contrib) contribute. The
// optional `stats` output counts the contributing pairs, those clamped at
// alpha_max, and the pairs K5 tests; the kernel is built twice, and the
// copy without `stats` carries no counting code.
//
// Each pixel starts at its own last contributor with T = T_final and
// recovers each earlier entry's incoming transmittance by dividing by
// (1 - alpha), so nothing per entry is saved by the forward. Whether an
// entry contributed is decided by entry_alpha, the very code K3 ran, and
// the entries past a pixel's last contributor are never visited: the
// contributor set is K3's exactly.
//
// Tile range: as K3, the rows are the tiles from flat tile t0 with pixel
// coordinates from the global tile; a row past the grid adds nothing, and
// the cull's proof is checked against the grid. The tile-sharded render
// sums each shard's payload gradient over its ranks.
//
// Design. A tile whose side is a multiple of 16 is split into 16x16
// squares, one 256-thread block each (4 blocks per 32x32 tile); another
// tile (8 or 24) is one block. Each warp takes an 8x4 patch of pixels.
// The block walks its table row back to front from the largest
// last_contrib of its own pixels, each warp only from the largest of its
// own, in shared-memory batches of kBatch payload rows. Per batch:
// - each entry gets a pixel box (composite_math.cuh:entry_box, where its
//   proof is; K3 culls with the same box) outside which entry_alpha is
//   false; a warp takes 32 entries at a time, each lane
//   testing one entry's box against the warp's patch, and runs the pixel
//   code only for the entries whose box meets it (most entries of a tile
//   list cover a few patches of the tile: on the LLFF inputs 4.3% of the
//   pairs walked contribute);
// - where any lane contributes, a reduce-scatter over the warp (16
//   shuffles for the 13 gradients padded to 16, leaving one field's sum on
//   each even lane) is stored into the warp's own slot [warp][entry][13]
//   of shared memory, and the warp's bit is set in the entry's word of
//   warps (an integer atomicOr, whose result no order changes): a warp
//   visits an entry at most once per batch, so no two threads meet on a
//   slot;
// - after the batch, one thread per (entry, field) sums the slots of the
//   warps in the entry's word, warps 0, 1, ... in that order, and stores the
//   block's sum at the entry's position of a partials scratch
//   [rows * squares, K, 13] (every entry below the block's start, zeros
//   included, so the scratch needs no clearing); the block's start goes
//   to tops[row * squares + square].
// Two more launches of this file make the payload gradient from the
// partials in a fixed order:
// - entry_map_kernel, before: for each table slot (row r, slot k) holding
//   Gaussian g, the index d of the tile in g's rect, row-major (the
//   enumeration of K2's D cap, binning.py:build_table_plain), and
//   map[g][d] = r * K + k; -1 (a memset) where no slot holds (g, d): the
//   tiles past D, past K, or outside this table's tile range;
// - reduce_kernel, after: one thread per (Gaussian, field) adds, for
//   d = 0, 1, ... up to the lesser of D and the tiles of the Gaussian's
//   rect, and each square in order, the partial of every mapped slot
//   below that square's start, and writes the row (the sentinel row P
//   zero), so d_payload needs no clearing either.
// No float atomic remains: every sum runs in an order fixed by the table
// and the pixel layout, so the same inputs give the same bits on every
// launch. Scratch: the partials, 4 * rows * squares * K * 13 bytes (40.9
// MB at LLFF with K 1,024), the map, 4 * P * D bytes, and tops.
// Built for sm_90a: see the build's -Xptxas -v lines (chip_smoke.py prints
// them); dynamic shared memory per block (kBatch rows):
// kBatch * (16 + 4 * 13 + 4 + 4 + 4 * 13 * warps) bytes, 62,976 at 8 warps.
// Both instances opt in, once per device, to the largest block's.

#include <atomic>

#include "composite_math.cuh"

namespace {

constexpr int kBatch = 128;     // payload rows per shared-memory batch
constexpr int kRed = 16;        // the 13 payload gradients padded for the reduce-scatter
constexpr int kMapThreads = 256;
constexpr int kMaxBlockWarps = 24 * 24 / 32;  // warps of the largest block (a 24-pixel tile)
using sdpgs_comp::Box;
using sdpgs_comp::kFullMask;
using sdpgs_comp::kMaxThreads;
using sdpgs_comp::kPatchH;
using sdpgs_comp::kPatchW;
using sdpgs_comp::warp_sum;

// One halving step of the reduce-scatter: lanes with `bit` set keep the
// upper half of v[0, 2h), the others the lower, each adding its partner's.
template <int kHalf>
__device__ __forceinline__ void keep_half(float (&v)[kRed], int lane, int bit) {
  const bool upper = (lane & bit) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, bit);
  }
}

// Sums v[0, 16) over the warp; returns on every lane the total of field
// reduced_field(lane) (both lanes of each pair hold the same one).
__device__ __forceinline__ float reduce_scatter(float (&v)[kRed], int lane) {
  keep_half<8>(v, lane, 16);
  keep_half<4>(v, lane, 8);
  keep_half<2>(v, lane, 4);
  keep_half<1>(v, lane, 2);
  return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
}

__device__ __forceinline__ int reduced_field(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 +
         ((lane >> 1) & 1);
}

// Dynamic shared memory of a block of `warps` warps, in bytes.
size_t smem_bytes(int warps) {
  return (size_t)kBatch * (sizeof(Box) + 4 * SDPGS_NPAY + 4 + 4 + 4 * SDPGS_NPAY * warps);
}

// map[g * D + d] = r * K + k for each slot (r, k) of the table holding
// Gaussian g, d the row-major index of the slot's tile in g's packed rect
// (binning.py:pack_rect); the map was set to -1 before.
__global__ void entry_map_kernel(const int* __restrict__ table, const int* __restrict__ rects,
                                 int* __restrict__ map, int P, int num_tiles, int t0,
                                 int grid_tiles, int tiles_x, int K, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)num_tiles * K) return;
  const int g = table[i];
  const int gt = t0 + (int)(i / K);
  if (g < 0 || g >= P || gt >= grid_tiles) return;
  const int rect = rects[g];
  const int xmin = rect & 0xFF, xmax = (rect >> 8) & 0xFF;
  const int ymin = (rect >> 16) & 0xFF, ymax = (rect >> 24) & 0xFF;
  const int tx = gt % tiles_x, ty = gt / tiles_x;
  if (tx < xmin || tx >= xmax || ty < ymin || ty >= ymax) return;
  const int d = (ty - ymin) * (xmax - xmin) + (tx - xmin);
  if (d < D) map[(size_t)g * D + d] = (int)i;
}

// d_payload[g][f]: the partials of Gaussian g's slots, d = 0, 1, ... below
// D and its rect's tile count, each over the tile's squares in order; row P
// (the sentinel) is zero.
__global__ void reduce_kernel(const int* __restrict__ map, const int* __restrict__ rects,
                              const float* __restrict__ partial, const int* __restrict__ tops,
                              float* __restrict__ d_payload, int P, int K, int D, int squares) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(P + 1) * SDPGS_NPAY) return;
  const int g = (int)(i / SDPGS_NPAY);
  const int f = (int)(i - (long long)g * SDPGS_NPAY);
  float sum = 0.0f;
  if (g < P) {
    const int rect = rects[g];
    const int n = min(D, (((rect >> 8) & 0xFF) - (rect & 0xFF)) *
                             (((rect >> 24) & 0xFF) - ((rect >> 16) & 0xFF)));
    for (int d = 0; d < n; ++d) {
      const int m = map[(size_t)g * D + d];
      if (m < 0) continue;
      const int r = m / K;
      const int k = m - r * K;
      for (int sq = 0; sq < squares; ++sq) {
        const int part = r * squares + sq;
        if (k < tops[part]) sum += partial[((size_t)part * K + k) * SDPGS_NPAY + f];
      }
    }
  }
  d_payload[i] = sum;
}

template <bool kStats>
__global__ void __launch_bounds__(kMaxThreads)
composite_bwd_kernel(const float* __restrict__ payload, const int* __restrict__ table,
                     const float* __restrict__ final_t,
                     const int* __restrict__ last_contrib,
                     const float* __restrict__ g_values,
                     const float* __restrict__ g_final_t, float* __restrict__ partial,
                     int* __restrict__ tops,
                     unsigned long long* __restrict__ stats, int P, int t0, int grid_tiles,
                     int tiles_x, int tile, int square, int K, float alpha_min,
                     float alpha_max, bool cull) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x >> 5;
  Box* s_box = reinterpret_cast<Box*>(smem4);                              // [kBatch]
  float (*s_pay)[kBatch] = reinterpret_cast<float (*)[kBatch]>(s_box + kBatch);  // [13][kBatch]
  float* s_slot = reinterpret_cast<float*>(s_pay + SDPGS_NPAY);  // [warps][kBatch][13]
  int* s_gid = reinterpret_cast<int*>(s_slot + (size_t)warps * kBatch * SDPGS_NPAY);
  unsigned* s_who = reinterpret_cast<unsigned*>(s_gid + kBatch);  // [kBatch]: warps, a bit each
  __shared__ int s_top;

  // block -> (tile, square), thread -> (8x4 patch, pixel): K3's pixel index
  const int squares_x = tile / square;
  const int t = blockIdx.x / (squares_x * squares_x);
  const int sq = blockIdx.x - t * squares_x * squares_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int lx, ly;
  sdpgs_comp::patch_pixel(sq, warp, lane, tile, square, lx, ly);
  const int gt = t0 + t;  // the global tile of row t
  const float px = (float)((gt % tiles_x) * tile + lx);
  const float py = (float)((gt / tiles_x) * tile + ly);
  // the warp's patch: pixel centres [px0, px0 + 7] x [py0, py0 + 3]
  const float px0 = px - (float)(lane % kPatchW);
  const float py0 = py - (float)(lane / kPatchW);
  const int* row = table + (size_t)t * K;
  const size_t o = (size_t)t * tile * tile + ly * tile + lx;
  // this block's partials: [K][13] of the scratch
  float* out = partial + (size_t)blockIdx.x * K * SDPGS_NPAY;

  const int my_last = gt < grid_tiles ? last_contrib[o] : 0;  // a row past the grid: none
  float g[SDPGS_NCH];
#pragma unroll
  for (int ch = 0; ch < SDPGS_NCH; ++ch) g[ch] = g_values[o * SDPGS_NCH + ch];
  float T = final_t[o];
  float S = T * g_final_t[o];
  int n_contrib = 0, n_clamped = 0, n_tested = 0;  // telemetry for `stats`

  if (threadIdx.x == 0) s_top = 0;
  __syncthreads();
  const int warp_top = __reduce_max_sync(kFullMask, my_last);
  if (lane == 0 && warp_top > 0) atomicMax(&s_top, warp_top);
  __syncthreads();
  const int top = s_top;
  if (threadIdx.x == 0) tops[blockIdx.x] = top;

  for (int b_end = top; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    const int n = b_end - b0;
    __syncthreads();  // the previous batch has been consumed and stored
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int gid = row[b0 + i];
      s_gid[i] = (gid >= 0 && gid <= P) ? gid : P;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_who[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < n * SDPGS_NPAY; i += blockDim.x) {
      const int e = i / SDPGS_NPAY;
      const int f = i - e * SDPGS_NPAY;
      s_pay[f][e] = payload[(size_t)s_gid[e] * SDPGS_NPAY + f];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      s_box[e] = cull ? sdpgs_comp::entry_box(s_pay[0][e], s_pay[1][e], s_pay[2][e],
                                              s_pay[3][e], s_pay[4][e], s_pay[5][e], alpha_min)
                      : Box{-INFINITY, INFINITY, -INFINITY, INFINITY};
    }
    __syncthreads();
    // 32 entries at a time, back to front, lane l testing entry e0 - l's box
    // against the warp's patch; entries at or past the warp's last
    // contributor are not walked
    float* my_slot = s_slot + (size_t)warp * kBatch * SDPGS_NPAY;
    for (int e0 = min(n, warp_top - b0) - 1; e0 >= 0; e0 -= 32) {
      bool touches = false;
      if (e0 - lane >= 0) {
        touches = sdpgs_comp::box_meets(s_box[e0 - lane], px0, px0 + (kPatchW - 1), py0,
                                        py0 + (kPatchH - 1));
      }
      unsigned todo = __ballot_sync(kFullMask, touches);
      while (todo != 0) {
        const int e = e0 - (__ffs(todo) - 1);
        todo &= todo - 1;
        float grad[kRed];
        bool contrib = false;
        if (b0 + e < my_last) {
          if (kStats) ++n_tested;
          sdpgs_comp::EntryAlpha ea;
          if (sdpgs_comp::entry_alpha(s_pay[0][e], s_pay[1][e], s_pay[2][e], s_pay[3][e],
                                      s_pay[4][e], s_pay[5][e], px, py, alpha_min,
                                      alpha_max, ea)) {
            float v[SDPGS_NCH];
#pragma unroll
            for (int ch = 0; ch < SDPGS_NCH; ++ch) v[ch] = s_pay[6 + ch][e];
            sdpgs_comp::entry_grad(ea, s_pay[2][e], s_pay[3][e], s_pay[4][e], v, g,
                                   alpha_max, T, S, grad);
            contrib = true;
            if (kStats) {
              ++n_contrib;
              n_clamped += !(ea.alpha_raw < alpha_max);
            }
          }
        }
        if (!__any_sync(kFullMask, contrib)) continue;
#pragma unroll
        for (int f = 0; f < kRed; ++f) grad[f] = (contrib && f < SDPGS_NPAY) ? grad[f] : 0.0f;
        const float sum = reduce_scatter(grad, lane);
        const int f = reduced_field(lane);
        if ((lane & 1) == 0 && f < SDPGS_NPAY) my_slot[e * SDPGS_NPAY + f] = sum;
        if (lane == 0) atomicOr(&s_who[e], 1u << warp);
      }
    }
    __syncthreads();
    // the block's sums, warps in order, into the partials at the entries'
    // positions (zeros included)
    for (int i = threadIdx.x; i < n * SDPGS_NPAY; i += blockDim.x) {
      float v = 0.0f;
      for (unsigned who = s_who[i / SDPGS_NPAY]; who != 0u; who &= who - 1u) {
        const int w = __ffs(who) - 1;  // the lowest warp left: warps in ascending order
        v += s_slot[((size_t)w * kBatch) * SDPGS_NPAY + i];
      }
      out[(size_t)b0 * SDPGS_NPAY + i] = v;
    }
  }

  if (kStats) {
    const int c0 = warp_sum(n_contrib), c1 = warp_sum(n_clamped), c2 = warp_sum(n_tested);
    if (lane == 0) {
      atomicAdd(&stats[0], (unsigned long long)c0);
      atomicAdd(&stats[1], (unsigned long long)c1);
      atomicAdd(&stats[2], (unsigned long long)c2);
    }
  }
}

// Opts both instances in to the largest block's dynamic shared memory, once
// per device (the attribute belongs to the device's context).
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  const int smem = (int)smem_bytes(kMaxBlockWarps);
  err = cudaFuncSetAttribute(composite_bwd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(composite_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// payload [P+1, 13] f32 (row P = zero sentinel), table [num_tiles, K] i32
// whose rows are the tiles from flat tile t0 of a grid of grid_tiles tiles
// (a row past the grid adds nothing), rects [P] i32 the packed tile rects
// binning listed the Gaussians by (binning.py:pack_rect), D its cap,
// final_t and g_final_t [num_tiles, tile^2] f32, last_contrib
// [num_tiles, tile^2] i32 (from K3), g_values [num_tiles, tile^2, 7] f32;
// d_payload [P+1, 13] f32 receives the gradient (row P zero). Scratch,
// uninitialised: map [P, D] i32, partial [num_tiles * squares, K, 13] f32,
// tops [num_tiles * squares] i32 (squares: the tile's 16x16 squares, or 1
// where 16 does not divide it).
// stats, when not null, is 3 u64 zeroed by the caller and receives the
// contributing (entry, pixel) pairs, those of them clamped at alpha_max,
// and the pairs tested (entry_alpha evaluated).
SDPGS_API int sdpgs_composite_bwd(const float* payload, const int* table, const int* rects,
                                  const float* final_t, const int* last_contrib,
                                  const float* g_values, const float* g_final_t,
                                  float* d_payload, unsigned long long* stats, int* map,
                                  float* partial, int* tops, int P, int num_tiles, int t0,
                                  int grid_tiles, int tiles_x, int tile, int K, int D,
                                  float alpha_min, float alpha_max, void* stream) {
  const int npix = tile * tile;
  if (npix > 1024 || npix <= 0 || npix % 32 != 0 || t0 < 0 || D < 1 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tile^2 a multiple of 32 makes the tile a multiple of 8: 8, 16, 24 or 32
  const int square = sdpgs_comp::square_side(tile);
  const int squares = (tile / square) * (tile / square);
  cudaError_t err = cudaMemsetAsync(map, 0xFF, sizeof(int) * (size_t)P * D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    const long long slots = (long long)num_tiles * K;
    entry_map_kernel<<<(unsigned)((slots + kMapThreads - 1) / kMapThreads), kMapThreads, 0, s>>>(
        table, rects, map, P, num_tiles, t0, grid_tiles, tiles_x, K, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool cull = sdpgs_comp::cull_holds(tiles_x, grid_tiles, tile, alpha_min);
    auto kernel = stats != nullptr ? composite_bwd_kernel<true> : composite_bwd_kernel<false>;
    const size_t smem = smem_bytes(square * square / 32);
    err = opt_in_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<num_tiles * squares, square * square, smem, s>>>(
        payload, table, final_t, last_contrib, g_values, g_final_t, partial, tops, stats, P,
        t0, grid_tiles, tiles_x, tile, square, K, alpha_min, alpha_max, cull);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = (long long)(P + 1) * SDPGS_NPAY;
  reduce_kernel<<<(unsigned)((rows + kMapThreads - 1) / kMapThreads), kMapThreads, 0, s>>>(
      map, rects, partial, tops, d_payload, P, K, D, squares);
  return static_cast<int>(cudaGetLastError());
}
