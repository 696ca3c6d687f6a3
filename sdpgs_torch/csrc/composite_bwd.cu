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
// Bound on the H100: f32 arithmetic on the CUDA cores. Every (entry,
// pixel) pair up to the pixel's last contributor (K3's last_contrib) needs
// the alpha test (~16 operations with one exp); only the contributing
// pairs, a small share, need the gradient and its sum into the entry's row
// (~61). The optional `stats` output counts the contributing pairs of the
// run's data; the kernel is built twice, and the copy without `stats`
// carries no counting code. The atomics and the bytes (payload, table, cotangents, the
// gradient) come on top.
//
// Design (the reference's backward.cu:399-557): one block per tile, one
// thread per pixel (tile^2 <= 1024, a multiple of 32). The block walks its
// table row back to front from the largest last_contrib of its pixels, in
// shared-memory batches of 256 payload rows. Each pixel starts at its own
// last contributor with T = T_final and recovers each earlier entry's
// incoming transmittance by dividing by (1 - alpha), so nothing per entry
// is saved by the forward. Whether an entry contributed is decided by
// entry_alpha, the very code K3 ran, and the entries past a pixel's last
// contributor (the one that would have taken T below 1e-4, and all later
// ones) are never visited: the contributor set is K3's exactly. The 13
// per-pixel gradients of an entry are summed across the warp with
// shuffles, and lane 0 adds them to the entry's payload row with
// atomicAdd; the zero sentinel row P is skipped.
//
// Float atomics make the order of each row's sum, and so its last bits,
// vary from run to run: the gradient is not bitwise deterministic.

#include "composite_math.cuh"

namespace {

constexpr int kBatch = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {  // lane 0 gets the warp's sum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

template <bool kStats>
__global__ void __launch_bounds__(1024)
composite_bwd_kernel(const float* __restrict__ payload, const int* __restrict__ table,
                     const float* __restrict__ final_t,
                     const int* __restrict__ last_contrib,
                     const float* __restrict__ g_values,
                     const float* __restrict__ g_final_t, float* __restrict__ d_payload,
                     unsigned long long* __restrict__ stats, int P, int tiles_x, int tile,
                     int K, float alpha_min, float alpha_max) {
  __shared__ float s_pay[SDPGS_NPAY][kBatch];
  __shared__ int s_gid[kBatch];
  __shared__ int s_top;
  const int t = blockIdx.x;
  const int npix = tile * tile;
  const int pix = threadIdx.x;
  const int lane = pix & 31;
  const float px = (float)((t % tiles_x) * tile + pix % tile);
  const float py = (float)((t / tiles_x) * tile + pix / tile);
  const int* row = table + (size_t)t * K;
  const size_t o = (size_t)t * npix + pix;

  const int my_last = last_contrib[o];
  float g[SDPGS_NCH];
#pragma unroll
  for (int ch = 0; ch < SDPGS_NCH; ++ch) g[ch] = g_values[o * SDPGS_NCH + ch];
  float T = final_t[o];
  float S = T * g_final_t[o];
  int n_contrib = 0, n_clamped = 0;  // telemetry for `stats`

  if (pix == 0) s_top = 0;
  __syncthreads();
  if (my_last > 0) atomicMax(&s_top, my_last);
  __syncthreads();
  const int top = s_top;

  for (int b_end = top; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    const int n = b_end - b0;
    __syncthreads();  // the previous batch has been consumed
    for (int i = pix; i < n; i += blockDim.x) {
      const int gid = row[b0 + i];
      s_gid[i] = (gid >= 0 && gid <= P) ? gid : P;
    }
    __syncthreads();
    for (int i = pix; i < n * SDPGS_NPAY; i += blockDim.x) {
      const int e = i / SDPGS_NPAY;
      const int f = i - e * SDPGS_NPAY;
      s_pay[f][e] = payload[(size_t)s_gid[e] * SDPGS_NPAY + f];
    }
    __syncthreads();
    for (int e = n - 1; e >= 0; --e) {
      float grad[SDPGS_NPAY];
      bool contrib = false;
      if (b0 + e < my_last) {
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
      const int gid = s_gid[e];
      if (__any_sync(kFullMask, contrib) && gid != P) {
#pragma unroll
        for (int f = 0; f < SDPGS_NPAY; ++f) {
          const float v = warp_sum(contrib ? grad[f] : 0.0f);
          if (lane == 0) atomicAdd(&d_payload[(size_t)gid * SDPGS_NPAY + f], v);
        }
      }
    }
  }

  if (kStats) {
    const int c0 = warp_sum(n_contrib), c1 = warp_sum(n_clamped);
    if (lane == 0) {
      atomicAdd(&stats[0], (unsigned long long)c0);
      atomicAdd(&stats[1], (unsigned long long)c1);
    }
  }
}

}  // namespace

// payload [P+1, 13] f32 (row P = zero sentinel), table [num_tiles, K] i32,
// final_t and g_final_t [num_tiles, tile^2] f32, last_contrib
// [num_tiles, tile^2] i32 (from K3), g_values [num_tiles, tile^2, 7] f32;
// d_payload [P+1, 13] f32, zeroed by the caller, accumulates the gradient
// (row P stays zero). stats, when not null, is 2 u64 zeroed by the caller
// and receives the contributing (entry, pixel) pairs and those of them
// clamped at alpha_max.
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
  auto kernel = stats != nullptr ? composite_bwd_kernel<true> : composite_bwd_kernel<false>;
  kernel<<<num_tiles, npix, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, table, final_t, last_contrib, g_values, g_final_t, d_payload, stats, P,
      tiles_x, tile, K, alpha_min, alpha_max);
  return static_cast<int>(cudaGetLastError());
}
