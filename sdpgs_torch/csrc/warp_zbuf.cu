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
// d > 0. Valid rows scatter-min z into out[pair, v, u].
//
// The TPU kernel sweeps a static window of (dv, du) displacements over
// transposed, padded slabs with packed codes, because a TPU has no cheap
// scatter; rows outside the window are counted and left to an XLA
// fallback. None of that is carried over: here every row scatters, so the
// result is the exact scatter-min for every pair and there are no
// outliers.
//
// Bound on the H100: bytes. The output ([B, V, H, W] f32, 146 MB at
// B = 64, V = 3, 504x378) is written once and the depths (2.3 MB) read
// once: 0.044 ms at 3.35 TB/s. The kernel moves about three times that
// (the +inf fill, the scatter's read-modify-write in L2, the finalize
// pass), and the atomics of the ~36.6 M rows contend only where rows
// collide on one pixel.
//
// Design: one thread per source pixel per pair, on a 2-D grid (pixel
// blocks x pairs); the pair's 12 floats sit in shared memory. z > 0 on
// every valid row, so the IEEE bits of z order like int32 and atomicMin
// on int over a buffer filled with +inf bits is the scatter-min; a last
// pass turns +inf into 0. Built with -fmad=false and evaluated in the
// plain version's association order, so u, v and z round exactly as
// there: min is order-free, so the z-buffers are bit-identical.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInfBits = 0x7f800000;

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
  const int view = pair % V;
  const float d = depths[(size_t)view * npix + i];
  const float x = (float)(i % W);
  const float y = (float)(i / W);
  // (P_r0 x + P_r1 y + P_r2) d + c_r, each product and sum rounded once
  const float X0 = (m[0] * x + m[1] * y + m[2]) * d + m[3];
  const float X1 = (m[4] * x + m[5] * y + m[6]) * d + m[7];
  const float z = (m[8] * x + m[9] * y + m[10]) * d + m[11];
  const float u = rintf(X0 / z);
  const float v = rintf(X1 / z);
  // the bounds test on the rounded floats: equal to JAX's test on the
  // int32 casts, and no float-to-int conversion of an out-of-range value
  const bool valid = u >= 0.0f && u < (float)W && v >= 0.0f && v < (float)H &&
                     z > 0.0f && d > 0.0f;
  if (!valid) return;
  const size_t dst = (size_t)pair * npix + (size_t)v * W + (size_t)u;
  atomicMin(out + dst, __float_as_int(z));
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && out[i] == kInfBits) out[i] = 0;  // the bits of 0.0f
}

}  // namespace

// depths [V, H, W] f32; pc [n_pairs, 12] f32, pair p = b * V + v holding
// [proj | c] row-major (proj_r0, proj_r1, proj_r2, c_r for r = 0, 1, 2);
// out [n_pairs, H, W] f32, written whole (0 = hole).
SDPGS_API int sdpgs_warp_zbuf(const float* depths, const float* pc, float* out,
                              int n_pairs, int V, int H, int W, void* stream) {
  const long long n = (long long)n_pairs * H * W;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bits = reinterpret_cast<int*>(out);
  const unsigned flat_blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fill_kernel<<<flat_blocks, kThreads, 0, s>>>(bits, n);
  dim3 grid((H * W + kThreads - 1) / kThreads, n_pairs);
  zbuf_kernel<<<grid, kThreads, 0, s>>>(depths, pc, bits, V, H, W);
  finalize_kernel<<<flat_blocks, kThreads, 0, s>>>(bits, n);
  return static_cast<int>(cudaGetLastError());
}
