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
// arithmetic on the CUDA cores, whichever is longer. The function needs,
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
// Design. A tile whose side is a multiple of 16 is split into 16x16
// squares, one 256-thread block each (4 blocks per 32x32 tile); another
// tile (8 or 24) is one block. Each warp takes an 8x4 patch of pixels.
// The block walks its table row back to front from the largest
// last_contrib of its own pixels, each warp only from the largest of its
// own, in shared-memory batches of 256 payload rows. Per batch:
// - each entry gets a pixel box (composite_math.cuh:entry_box, where its
//   proof is; K3 culls with the same box) outside which entry_alpha is
//   false; a warp takes 32 entries at a time, each lane
//   testing one entry's box against the warp's patch, and runs the pixel
//   code only for the entries whose box meets it (most entries of a tile
//   list cover a few patches of the tile: on the LLFF inputs 4.3% of the
//   pairs walked contribute);
// - where any lane contributes, a reduce-scatter over the warp (16
//   shuffles for the 13 gradients padded to 16, leaving one field's sum on
//   each even lane) feeds one shared add per field into an entry-major
//   [256][13] accumulator, so the 13 adds fall in 13 banks. Shared float
//   atomics are compare-and-swap loops on this card, so a warp adds once
//   per field, whatever the number of contributing lanes;
// - after the batch, one thread per (entry, field) adds the block's
//   non-zero sums to d_payload: one global atomic per (block, entry,
//   field), so no two warps of a block meet on a global address. The zero
//   sentinel row P is never written.
// Built for sm_90a: 71 and 73 registers (the two instances), no spill,
// 31.7 KB of shared memory (nvcc -Xptxas -v).
//
// Float atomics make the order of each row's sum, and so its last bits,
// vary from run to run: the gradient is not bitwise deterministic.

#include "composite_math.cuh"

namespace {

constexpr int kBatch = 256;     // payload rows per shared-memory batch
constexpr int kRed = 16;        // the 13 payload gradients padded for the reduce-scatter
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

template <bool kStats>
__global__ void __launch_bounds__(kMaxThreads)
composite_bwd_kernel(const float* __restrict__ payload, const int* __restrict__ table,
                     const float* __restrict__ final_t,
                     const int* __restrict__ last_contrib,
                     const float* __restrict__ g_values,
                     const float* __restrict__ g_final_t, float* __restrict__ d_payload,
                     unsigned long long* __restrict__ stats, int P, int tiles_x, int tile,
                     int square, int K, float alpha_min, float alpha_max, bool cull) {
  __shared__ float s_pay[SDPGS_NPAY][kBatch];
  __shared__ float s_acc[kBatch * SDPGS_NPAY];  // entry-major: a row's 13 in 13 banks
  __shared__ Box s_box[kBatch];
  __shared__ int s_gid[kBatch];
  __shared__ int s_top;

  // block -> (tile, square), thread -> (8x4 patch, pixel): K3's pixel index
  const int squares_x = tile / square;
  const int t = blockIdx.x / (squares_x * squares_x);
  const int sq = blockIdx.x - t * squares_x * squares_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int lx, ly;
  sdpgs_comp::patch_pixel(sq, warp, lane, tile, square, lx, ly);
  const float px = (float)((t % tiles_x) * tile + lx);
  const float py = (float)((t / tiles_x) * tile + ly);
  // the warp's patch: pixel centres [px0, px0 + 7] x [py0, py0 + 3]
  const float px0 = px - (float)(lane % kPatchW);
  const float py0 = py - (float)(lane / kPatchW);
  const int* row = table + (size_t)t * K;
  const size_t o = (size_t)t * tile * tile + ly * tile + lx;

  const int my_last = last_contrib[o];
  float g[SDPGS_NCH];
#pragma unroll
  for (int ch = 0; ch < SDPGS_NCH; ++ch) g[ch] = g_values[o * SDPGS_NCH + ch];
  float T = final_t[o];
  float S = T * g_final_t[o];
  int n_contrib = 0, n_clamped = 0, n_tested = 0;  // telemetry for `stats`

  for (int i = threadIdx.x; i < SDPGS_NPAY * kBatch; i += blockDim.x) s_acc[i] = 0.0f;
  if (threadIdx.x == 0) s_top = 0;
  __syncthreads();
  const int warp_top = __reduce_max_sync(kFullMask, my_last);
  if (lane == 0 && warp_top > 0) atomicMax(&s_top, warp_top);
  __syncthreads();
  const int top = s_top;

  for (int b_end = top; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    const int n = b_end - b0;
    __syncthreads();  // the previous batch has been consumed and flushed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int gid = row[b0 + i];
      s_gid[i] = (gid >= 0 && gid <= P) ? gid : P;
    }
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
        if ((lane & 1) == 0 && f < SDPGS_NPAY) atomicAdd(&s_acc[e * SDPGS_NPAY + f], sum);
      }
    }
    __syncthreads();
    // the block's sums into the payload gradient, the accumulator back to 0
    for (int i = threadIdx.x; i < n * SDPGS_NPAY; i += blockDim.x) {
      const float v = s_acc[i];
      if (v != 0.0f) {
        s_acc[i] = 0.0f;
        const int e = i / SDPGS_NPAY;
        const int gid = s_gid[e];
        if (gid != P) atomicAdd(&d_payload[(size_t)gid * SDPGS_NPAY + (i - e * SDPGS_NPAY)], v);
      }
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

}  // namespace

// payload [P+1, 13] f32 (row P = zero sentinel), table [num_tiles, K] i32,
// final_t and g_final_t [num_tiles, tile^2] f32, last_contrib
// [num_tiles, tile^2] i32 (from K3), g_values [num_tiles, tile^2, 7] f32;
// d_payload [P+1, 13] f32, zeroed by the caller, accumulates the gradient
// (row P stays zero). stats, when not null, is 3 u64 zeroed by the caller
// and receives the contributing (entry, pixel) pairs, those of them
// clamped at alpha_max, and the pairs tested (entry_alpha evaluated).
SDPGS_API int sdpgs_composite_bwd(const float* payload, const int* table,
                                  const float* final_t, const int* last_contrib,
                                  const float* g_values, const float* g_final_t,
                                  float* d_payload, unsigned long long* stats, int P,
                                  int num_tiles, int tiles_x, int tile, int K,
                                  float alpha_min, float alpha_max, void* stream) {
  const int npix = tile * tile;
  if (npix > 1024 || npix <= 0 || npix % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return 0;
  // tile^2 a multiple of 32 makes the tile a multiple of 8: 8, 16, 24 or 32
  const int square = sdpgs_comp::square_side(tile);
  const int squares = (tile / square) * (tile / square);
  const bool cull = sdpgs_comp::cull_holds(tiles_x, num_tiles, tile, alpha_min);
  auto kernel = stats != nullptr ? composite_bwd_kernel<true> : composite_bwd_kernel<false>;
  kernel<<<num_tiles * squares, square * square, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, table, final_t, last_contrib, g_values, g_final_t, d_payload, stats, P,
      tiles_x, tile, square, K, alpha_min, alpha_max, cull);
  return static_cast<int>(cudaGetLastError());
}
