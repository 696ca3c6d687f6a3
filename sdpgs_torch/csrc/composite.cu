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
// Bound on the H100: f32 arithmetic on the CUDA cores: the alpha test
// (~16 operations with one exp) for every (entry, pixel) pair visited and
// the blend (~18) for the contributing ones; the bytes (payload rows, the
// table, the outputs) take a few microseconds at 3.35 TB/s.
//
// Design: one block per tile, one thread per pixel (tile^2 <= 1024). The
// block gathers its table row's payload rows into shared memory in
// batches of 256 entries (13 floats each), so the [T, K, 13] gathered
// tensor of the plain version is never materialised; every thread then
// reads the batch as broadcasts. Each pixel multiplies its transmittance
// sequentially, like the reference CUDA kernel; the TPU kernels form it by
// chunked cumprod or a log-space triangular matmul, so a pixel near the
// 1e-4 threshold can keep one contributor more or fewer than they do. The
// block leaves once every pixel is done (__syncthreads_count) or the tile's
// count is reached. Each pixel also records how many entries it evaluated
// (n_visit), the work the run's data needed, and one past the last entry
// it added (last_contrib), where K5's back-to-front sweep starts. Whether
// an entry touches a pixel is decided by composite_math.cuh:entry_alpha,
// the code K5 runs too.
//
// last_contrib is kept although n_visit could carry the same start with
// the stop as its sign: measured on the H100 in one call, that encoding
// left K3 at 32 registers with a spill and no faster (0.2698-0.2782 ms
// against 0.2620-0.2746), while K5, which then also walks the entries
// skipped past each pixel's last contributor (8% more pairs), ran 0.7175
// against 0.6990 ms (PERF.md section 6).

#include "composite_math.cuh"

namespace {

constexpr int kBatch = 256;

__global__ void __launch_bounds__(1024)
composite_fwd_kernel(const float* __restrict__ payload, const int* __restrict__ table,
                     const int* __restrict__ counts, float* __restrict__ values,
                     float* __restrict__ final_t, int* __restrict__ n_visit,
                     int* __restrict__ last_contrib, int P, int tiles_x, int tile, int K,
                     float alpha_min, float alpha_max, float t_min) {
  __shared__ float s_pay[SDPGS_NPAY][kBatch];
  __shared__ int s_gid[kBatch];
  const int t = blockIdx.x;
  const int npix = tile * tile;
  const int pix = threadIdx.x;
  const float px = (float)((t % tiles_x) * tile + pix % tile);
  const float py = (float)((t / tiles_x) * tile + pix / tile);
  const int count = counts[t];
  const int* row = table + (size_t)t * K;

  float T = 1.0f;
  float acc[SDPGS_NCH];
#pragma unroll
  for (int ch = 0; ch < SDPGS_NCH; ++ch) acc[ch] = 0.0f;
  bool done = false;
  int visited = count;  // every entry, unless the pixel stops early
  int last = 0;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier before the shared batch is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, count - b0);
    for (int i = pix; i < n; i += blockDim.x) {
      const int gid = row[b0 + i];
      s_gid[i] = (gid >= 0 && gid <= P) ? gid : P;  // never read past the sentinel
    }
    __syncthreads();
    for (int i = pix; i < n * SDPGS_NPAY; i += blockDim.x) {
      const int e = i / SDPGS_NPAY;
      const int f = i - e * SDPGS_NPAY;
      s_pay[f][e] = payload[(size_t)s_gid[e] * SDPGS_NPAY + f];
    }
    __syncthreads();
    for (int e = 0; e < n && !done; ++e) {
      sdpgs_comp::EntryAlpha ea;
      if (!sdpgs_comp::entry_alpha(s_pay[0][e], s_pay[1][e], s_pay[2][e], s_pay[3][e],
                                   s_pay[4][e], s_pay[5][e], px, py, alpha_min,
                                   alpha_max, ea)) {
        continue;
      }
      const float test = T * (1.0f - ea.alpha);
      if (test < t_min) {
        done = true;
        visited = b0 + e + 1;
        break;
      }
      const float w = ea.alpha * T;
#pragma unroll
      for (int ch = 0; ch < SDPGS_NCH; ++ch) acc[ch] += w * s_pay[6 + ch][e];
      T = test;
      last = b0 + e + 1;
    }
  }

  const size_t o = (size_t)t * npix + pix;
#pragma unroll
  for (int ch = 0; ch < SDPGS_NCH; ++ch) values[o * SDPGS_NCH + ch] = acc[ch];
  final_t[o] = T;
  n_visit[o] = visited;
  last_contrib[o] = last;
}

}  // namespace

// payload [P+1, 13] f32 (row P = zero sentinel), table [num_tiles, K] i32
// (entries outside [0, P] read as the sentinel), counts [num_tiles] i32
// (<= K). values [num_tiles, tile^2, 7] f32, final_t [num_tiles, tile^2]
// f32, n_visit and last_contrib [num_tiles, tile^2] i32.
SDPGS_API int sdpgs_composite_fwd(const float* payload, const int* table,
                                  const int* counts, float* values, float* final_t,
                                  int* n_visit, int* last_contrib, int P, int num_tiles,
                                  int tiles_x, int tile, int K, float alpha_min,
                                  float alpha_max, float t_min, void* stream) {
  const int npix = tile * tile;
  if (npix > 1024 || npix <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  composite_fwd_kernel<<<num_tiles, npix, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, table, counts, values, final_t, n_visit, last_contrib, P, tiles_x, tile, K,
      alpha_min, alpha_max, t_min);
  return static_cast<int>(cudaGetLastError());
}
