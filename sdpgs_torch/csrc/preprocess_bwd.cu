// K4: fused per-Gaussian preprocess + SH colour, backward (vjp).
//
// Replaces sdpgs_tpu/ops/rasterize/preprocess_pallas.py:_bwd_kernel (the
// pl.pallas_call at :236, reached through the custom vjp of _pp_rows). The
// TPU kernel traces jax.vjp of the row math into the kernel; here the vjp
// is written by hand (preprocess_math.cuh:backward), as the reference does
// in backward.cu:144-396: screen centre and depth -> xyz, conic -> 2D
// covariance -> (J, W, R, S) -> normalized quaternion and activated scale,
// SH colour -> coefficients and, through the normalized view direction,
// xyz. Rows 0 (valid), 7 (radius) and 10 (alive) carry no gradient.
//
// Bound on the H100: bytes. Each Gaussian reads 11 geometry floats,
// 3*(deg+1)^2 SH floats and 11 cotangent floats and writes 11 + 3*(deg+1)^2
// gradient floats (129 floats, 516 bytes at degree 3) for a few hundred
// flops: far below the card's f32 ridge.
//
// Design: one thread per Gaussian over row-major [rows, P] arrays
// (coalesced, each byte streamed once). The thread recomputes the forward
// in registers with the very code K1 runs (preprocess_math.cuh:forward),
// and the file is built with -fmad=false like K1, so every mask the
// gradient passes through (the clip of tx/tz and ty/tz, the tz_safe and
// det_safe substitutions, the rgb clamp at 0) is decided on the same
// floats as in K1 and in the plain version; with a non-null `masks` the
// kernel writes each Gaussian's mask word for that check.

#include "preprocess_math.cuh"

namespace {

using sdpgs_pp::CamVec;

template <int DEG>
__global__ void __launch_bounds__(256)
preprocess_bwd_kernel(const float* __restrict__ geo, const float* __restrict__ sh,
                      const float* __restrict__ ct, float* __restrict__ dgeo,
                      float* __restrict__ dsh, int* __restrict__ masks, int P,
                      CamVec cam, int width, int height, float near, float low_pass) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t n = (size_t)P;
  float dg[11];
  const int mask = sdpgs_pp::backward<DEG>(geo, sh, ct, n, p, cam, width, height,
                                           near, low_pass, dg, dsh);
#pragma unroll
  for (int i = 0; i < 11; ++i) dgeo[i * n + p] = dg[i];
  if (masks != nullptr) masks[p] = mask;
}

}  // namespace

// geo [11, P], sh [3*(deg+1)^2, P], ct [11, P] in; dgeo [11, P],
// dsh [3*(deg+1)^2, P] out: f32, device, contiguous. masks: [P] int32 or
// null. cam: host pointer to the 39-float camera vector.
SDPGS_API int sdpgs_preprocess_bwd(const float* geo, const float* sh, const float* ct,
                                   const float* cam, float* dgeo, float* dsh,
                                   int* masks, int P, int deg, int width, int height,
                                   float near, float low_pass, void* stream) {
  CamVec cv;
  for (int i = 0; i < 39; ++i) cv.v[i] = cam[i];
  if (P == 0) return 0;
  const int threads = 256;
  const int blocks = (P + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDPGS_PP_BWD(D)                                                            \
  preprocess_bwd_kernel<D><<<blocks, threads, 0, s>>>(geo, sh, ct, dgeo, dsh, masks, \
                                                      P, cv, width, height, near,    \
                                                      low_pass)
  switch (deg) {
    case 0: SDPGS_PP_BWD(0); break;
    case 1: SDPGS_PP_BWD(1); break;
    case 2: SDPGS_PP_BWD(2); break;
    case 3: SDPGS_PP_BWD(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SDPGS_PP_BWD
  return static_cast<int>(cudaGetLastError());
}
