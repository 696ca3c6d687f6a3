// K1: fused per-Gaussian preprocess + SH colour, forward.
//
// Replaces sdpgs_tpu/ops/rasterize/preprocess_pallas.py:_fwd_kernel (the
// pl.pallas_call at :227, reached through preprocess_color_pallas). For each
// Gaussian: world->view, projection to pixels, quaternion+scale -> EWA 2D
// covariance (+low-pass) -> conic, 3-sigma radius, culling (near plane,
// det, alive, finite depth), and SH degree 0..3 -> RGB (+0.5, clamped at 0).
//
// Bound on the H100: bytes. Each Gaussian reads 11 geometry floats and
// 3*(deg+1)^2 SH floats and writes 11 floats (70 at degree 3, 280 bytes)
// for a few hundred flops: far below the card's ~20 flop/byte f32 ridge.
//
// Design: one thread per Gaussian over row-major [rows, P] inputs, so the
// threads of a warp read neighbouring addresses of every row (coalesced)
// and the kernel streams each byte once. The 39-float camera rides in the
// kernel's parameter space as a by-value struct. The arithmetic copies the
// plain version (preprocess_cuda.py:_row_math) operation by operation, in
// the same association order; the file is built with -fmad=false and IEEE
// division/sqrt, so each float op rounds as the plain PyTorch ops do and
// the step functions (radius = ceil(...), valid) agree with it exactly.
// The arithmetic lives in preprocess_math.cuh, shared with K4.

#include "preprocess_math.cuh"

namespace {

using sdpgs_pp::CamVec;

template <int DEG>
__global__ void __launch_bounds__(256)
preprocess_fwd_kernel(const float* __restrict__ geo, const float* __restrict__ sh,
                      float* __restrict__ out, int P, CamVec cam, int width,
                      int height, float near, float low_pass) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t n = (size_t)P;
  sdpgs_pp::Fwd f;
  sdpgs_pp::forward<DEG>(geo, sh, n, p, cam, width, height, near, low_pass, f);
  out[0 * n + p] = f.validf;
  out[1 * n + p] = f.mx;
  out[2 * n + p] = f.my;
  out[3 * n + p] = f.tz;
  out[4 * n + p] = f.ca;
  out[5 * n + p] = f.cb;
  out[6 * n + p] = f.cc;
  out[7 * n + p] = f.radius;
  out[8 * n + p] = f.rgb[0];
  out[9 * n + p] = f.rgb[1];
  out[10 * n + p] = f.rgb[2];
}

}  // namespace

SDPGS_API const char* sdpgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// geo [11, P], sh [3*(deg+1)^2, P], out [11, P]: f32, device, contiguous.
// cam: host pointer to the 39-float camera vector (copied into the launch).
SDPGS_API int sdpgs_preprocess_fwd(const float* geo, const float* sh,
                                   const float* cam, float* out, int P, int deg,
                                   int width, int height, float near,
                                   float low_pass, void* stream) {
  CamVec cv;
  for (int i = 0; i < 39; ++i) cv.v[i] = cam[i];
  if (P == 0) return 0;
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 0: preprocess_fwd_kernel<0><<<blocks, threads, 0, s>>>(geo, sh, out, P, cv, width, height, near, low_pass); break;
    case 1: preprocess_fwd_kernel<1><<<blocks, threads, 0, s>>>(geo, sh, out, P, cv, width, height, near, low_pass); break;
    case 2: preprocess_fwd_kernel<2><<<blocks, threads, 0, s>>>(geo, sh, out, P, cv, width, height, near, low_pass); break;
    case 3: preprocess_fwd_kernel<3><<<blocks, threads, 0, s>>>(geo, sh, out, P, cv, width, height, near, low_pass); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
