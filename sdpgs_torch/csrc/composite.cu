// K3: per-tile front-to-back compositing, forward.
//
// Replaces sdpgs_tpu/ops/rasterize/composite_pallas.py:_fwd_kernel (the
// pl.pallas_call at :283, reached through composite_tiles_pallas from
// rasterizer.py:192-199). Per pixel, the tile's depth-ordered entries
// composite front to back (reference forward.cu:261-374):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op e^power),
//   skipped when power > 0 or alpha < 1/255; a pixel stops at the entry
//   that would take its transmittance below 1e-4 (that entry is not added).
// Outputs: 7 channels (rgb, depth, feature) and the final transmittance.
//
// Bound on the H100: the bytes of its inputs and outputs (payload rows,
// the table, the 8 output channels), or f32 arithmetic on the CUDA cores
// for the function's own work, the alpha test (~16 operations with one
// exp) and the blend (~18) for each contributing (entry, pixel) pair,
// whichever is longer: at LLFF the bytes. Each pixel multiplies its
// transmittance sequentially, like the reference CUDA kernel; the TPU
// kernels form it by chunked cumprod or a log-space triangular matmul, so
// a pixel near the 1e-4 threshold can keep one contributor more or fewer
// than they do. Each pixel also records how many entries it walked up to
// its stop (n_visit: the stopping entry, or the tile's count) and one past
// the last entry it added (last_contrib), where K5's back-to-front sweep
// starts. Whether an entry touches a pixel is decided by
// composite_math.cuh:entry_alpha, the code K5 runs too.
//
// Tile range (the tile-sharded render, sdpgs_torch/parallel/tile_shard.py):
// the table's rows are the n_local tiles from flat tile t0, and a block
// takes its pixel coordinates from global tile t0 + its row; a row past the
// grid's own tile count is empty (values 0, final_t 1), and the cull's proof
// is checked against the grid, not the range.
//
// Design (K5's shape and K5's cull). A tile whose side is a multiple of 16
// is split into 16x16 squares, one 256-thread block each (4 blocks per
// 32x32 tile); a tile of 8 or 24 is one block. Each warp takes an 8x4
// patch of pixels (composite_math.cuh:patch_pixel, K5's index). A tile whose side 8 does not
// divide is cut row-major into blocks of up to 256 pixels, and each warp's
// patch is the bounding box of its 32 pixels. A block gathers its table
// row's payload rows into shared memory in batches of 256 (one thread per
// entry: 13 floats and the entry's pixel box, composite_math.cuh:entry_box,
// outside which entry_alpha is false), so the [T, K, 13] gathered tensor
// of the plain version is never materialised. A warp then takes 32 entries
// at a time, each lane testing one entry's box against the warp's patch in
// one ballot, and walks the set bits in increasing entry order, running
// entry_alpha and the blend only for those entries. The cull is exact: an
// entry whose box misses the patch fails entry_alpha at every pixel of the
// patch, and the unculled walk skips such an entry too, so T, the seven
// sums, the stop, n_visit and last_contrib are those of the walk over
// every entry, bit for bit. A warp leaves once all its pixels are done; a
// block once all its warps have (__syncthreads_count) or at the tile's
// count. The optional `stats` output counts the pairs tested (entry_alpha
// evaluated) and those that contributed; the kernel is built twice, and
// the copy without `stats` carries no counting code.
// Built for sm_90a: 55 and 56 registers (the two instances), no spill,
// 17.0 KB of shared memory (nvcc -Xptxas -v).
//
// last_contrib is kept although n_visit could carry the same start with
// the stop as its sign: measured on the H100 in one call, that encoding
// left the first K3 at 32 registers with a spill and no faster
// (0.2698-0.2782 ms against 0.2620-0.2746), while K5, which then also walks
// the entries skipped past each pixel's last contributor (8% more pairs),
// ran 0.7175 against 0.6990 ms (PERF.md section 6).

#include <climits>

#include "composite_math.cuh"

namespace {

constexpr int kBatch = 256;     // payload rows per shared-memory batch
constexpr int kChunk = 256;     // pixels per block where 8 does not divide the tile
using sdpgs_comp::Box;
using sdpgs_comp::kFullMask;
using sdpgs_comp::kMaxThreads;
using sdpgs_comp::kPatchW;
using sdpgs_comp::warp_sum;

// square > 0: the tile's side is a multiple of 8, blocks take square x
// square pixels in 8x4 patches; square == 0: blocks take kChunk pixels of
// the tile in row-major order.
template <bool kStats>
__global__ void __launch_bounds__(kMaxThreads)
composite_fwd_kernel(const float* __restrict__ payload, const int* __restrict__ table,
                     const int* __restrict__ counts, float* __restrict__ values,
                     float* __restrict__ final_t, int* __restrict__ n_visit,
                     int* __restrict__ last_contrib, unsigned long long* __restrict__ stats,
                     int P, int t0, int grid_tiles, int tiles_x, int tile, int square,
                     int blocks_per_tile, int K, float alpha_min, float alpha_max,
                     float t_min, bool cull) {
  __shared__ float s_pay[SDPGS_NPAY][kBatch];
  __shared__ Box s_box[kBatch];

  // block -> (row t of the range, part), thread -> pixel (lx, ly) of global
  // tile t0 + t
  const int t = blockIdx.x / blocks_per_tile;
  const int gt = t0 + t;
  const int part = blockIdx.x - t * blocks_per_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int lx, ly;
  bool active = true;
  if (square > 0) {
    sdpgs_comp::patch_pixel(part, warp, lane, tile, square, lx, ly);
  } else {
    const int i = part * kChunk + threadIdx.x;
    active = i < tile * tile;
    lx = i % tile;
    ly = i / tile;
  }
  const float tx0 = (float)((gt % tiles_x) * tile);
  const float ty0 = (float)((gt / tiles_x) * tile);
  const float px = tx0 + (float)lx;
  const float py = ty0 + (float)ly;
  // the warp's patch: the bounding box of its pixel centres
  const float x0 = tx0 + (float)__reduce_min_sync(kFullMask, active ? lx : INT_MAX);
  const float x1 = tx0 + (float)__reduce_max_sync(kFullMask, active ? lx : INT_MIN);
  const float y0 = ty0 + (float)__reduce_min_sync(kFullMask, active ? ly : INT_MAX);
  const float y1 = ty0 + (float)__reduce_max_sync(kFullMask, active ? ly : INT_MIN);
  const int count = gt < grid_tiles ? counts[t] : 0;
  const int* row = table + (size_t)t * K;

  float T = 1.0f;
  float acc[SDPGS_NCH];
#pragma unroll
  for (int ch = 0; ch < SDPGS_NCH; ++ch) acc[ch] = 0.0f;
  bool done = !active;
  int visited = count;  // every entry, unless the pixel stops early
  int last = 0;
  int n_tested = 0, n_contrib = 0;  // telemetry for `stats`

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier before the shared batch is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, count - b0);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int gid = row[b0 + e];
      // never read past the sentinel
      const float* src = payload + (size_t)((gid >= 0 && gid <= P) ? gid : P) * SDPGS_NPAY;
      float v[SDPGS_NPAY];
#pragma unroll
      for (int f = 0; f < SDPGS_NPAY; ++f) {
        v[f] = src[f];
        s_pay[f][e] = v[f];
      }
      s_box[e] = cull ? sdpgs_comp::entry_box(v[0], v[1], v[2], v[3], v[4], v[5], alpha_min)
                      : Box{-INFINITY, INFINITY, -INFINITY, INFINITY};
    }
    __syncthreads();
    // 32 entries at a time, lane l testing entry e0 + l's box against the
    // warp's patch; the set bits are walked in increasing entry order
    for (int e0 = 0; e0 < n && !__all_sync(kFullMask, done); e0 += 32) {
      const bool touches =
          e0 + lane < n && sdpgs_comp::box_meets(s_box[e0 + lane], x0, x1, y0, y1);
      unsigned todo = __ballot_sync(kFullMask, touches);
      while (todo != 0) {
        const int e = e0 + __ffs(todo) - 1;
        todo &= todo - 1;
        if (!done) {
          if (kStats) ++n_tested;
          sdpgs_comp::EntryAlpha ea;
          if (sdpgs_comp::entry_alpha(s_pay[0][e], s_pay[1][e], s_pay[2][e], s_pay[3][e],
                                      s_pay[4][e], s_pay[5][e], px, py, alpha_min,
                                      alpha_max, ea)) {
            const float test = T * (1.0f - ea.alpha);
            if (test < t_min) {
              done = true;
              visited = b0 + e + 1;
            } else {
              const float w = ea.alpha * T;
#pragma unroll
              for (int ch = 0; ch < SDPGS_NCH; ++ch) acc[ch] += w * s_pay[6 + ch][e];
              T = test;
              last = b0 + e + 1;
              if (kStats) ++n_contrib;
            }
          }
        }
        if (__all_sync(kFullMask, done)) break;
      }
    }
  }

  if (active) {
    const size_t o = (size_t)t * tile * tile + ly * tile + lx;
#pragma unroll
    for (int ch = 0; ch < SDPGS_NCH; ++ch) values[o * SDPGS_NCH + ch] = acc[ch];
    final_t[o] = T;
    n_visit[o] = visited;
    last_contrib[o] = last;
  }
  if (kStats) {
    const int c0 = warp_sum(n_tested), c1 = warp_sum(n_contrib);
    if (lane == 0) {
      atomicAdd(&stats[0], (unsigned long long)c0);
      atomicAdd(&stats[1], (unsigned long long)c1);
    }
  }
}

int launch(const float* payload, const int* table, const int* counts, float* values,
           float* final_t, int* n_visit, int* last_contrib, unsigned long long* stats, int P,
           int num_tiles, int t0, int grid_tiles, int tiles_x, int tile, int K,
           float alpha_min, float alpha_max, float t_min, void* stream) {
  const int npix = tile * tile;
  if (npix > 1024 || npix <= 0 || t0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  int square = 0, blocks_per_tile, threads;
  if (tile % kPatchW == 0) {  // 8, 16, 24 or 32
    square = sdpgs_comp::square_side(tile);
    blocks_per_tile = (tile / square) * (tile / square);
    threads = square * square;
  } else {
    blocks_per_tile = (npix + kChunk - 1) / kChunk;
    threads = npix < kChunk ? (npix + 31) / 32 * 32 : kChunk;
  }
  const bool cull = sdpgs_comp::cull_holds(tiles_x, grid_tiles, tile, alpha_min);
  auto kernel = stats != nullptr ? composite_fwd_kernel<true> : composite_fwd_kernel<false>;
  kernel<<<num_tiles * blocks_per_tile, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, table, counts, values, final_t, n_visit, last_contrib, stats, P, t0, grid_tiles,
      tiles_x, tile, square, blocks_per_tile, K, alpha_min, alpha_max, t_min, cull);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// payload [P+1, 13] f32 (row P = zero sentinel), table [num_tiles, K] i32
// (entries outside [0, P] read as the sentinel), counts [num_tiles] i32
// (<= K): the num_tiles rows are the tiles from flat tile t0 of a grid of
// grid_tiles tiles, tiles_x wide. values [num_tiles, tile^2, 7] f32,
// final_t [num_tiles, tile^2] f32, n_visit and last_contrib
// [num_tiles, tile^2] i32.
SDPGS_API int sdpgs_composite_fwd(const float* payload, const int* table,
                                  const int* counts, float* values, float* final_t,
                                  int* n_visit, int* last_contrib, int P, int num_tiles,
                                  int t0, int grid_tiles, int tiles_x, int tile, int K,
                                  float alpha_min, float alpha_max, float t_min,
                                  void* stream) {
  return launch(payload, table, counts, values, final_t, n_visit, last_contrib, nullptr, P,
                num_tiles, t0, grid_tiles, tiles_x, tile, K, alpha_min, alpha_max, t_min,
                stream);
}

// The same, through the instance that also counts: stats is 2 u64 zeroed by
// the caller and receives the (entry, pixel) pairs tested (entry_alpha
// evaluated) and the contributing pairs.
SDPGS_API int sdpgs_composite_fwd_stats(const float* payload, const int* table,
                                        const int* counts, float* values, float* final_t,
                                        int* n_visit, int* last_contrib,
                                        unsigned long long* stats, int P, int num_tiles,
                                        int t0, int grid_tiles, int tiles_x, int tile, int K,
                                        float alpha_min, float alpha_max, float t_min,
                                        void* stream) {
  return launch(payload, table, counts, values, final_t, n_visit, last_contrib, stats, P,
                num_tiles, t0, grid_tiles, tiles_x, tile, K, alpha_min, alpha_max, t_min,
                stream);
}
