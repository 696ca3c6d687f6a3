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

#include "common.cuh"

namespace {

struct CamVec {
  float v[39];  // view(16) full_proj(16) fx fy tan_fovx tan_fovy pos(3)
};

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f;
constexpr float C2_1 = -1.0925484305920792f;
constexpr float C2_2 = 0.31539156525252005f;
constexpr float C2_3 = -1.0925484305920792f;
constexpr float C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f;
constexpr float C3_1 = 2.890611442640554f;
constexpr float C3_2 = -0.4570457994644658f;
constexpr float C3_3 = 0.3731763325901154f;
constexpr float C3_4 = -0.4570457994644658f;
constexpr float C3_5 = 1.445305721320277f;
constexpr float C3_6 = -0.5900435899266435f;

// torch.clamp / clamp_min semantics: NaN propagates.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maxf_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

template <int DEG>
__global__ void __launch_bounds__(256)
preprocess_fwd_kernel(const float* __restrict__ geo, const float* __restrict__ sh,
                      float* __restrict__ out, int P, CamVec cam, int width,
                      int height, float near, float low_pass) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t n = (size_t)P;
  const float x = geo[0 * n + p], y = geo[1 * n + p], z = geo[2 * n + p];
  const float s0 = geo[3 * n + p], s1 = geo[4 * n + p], s2 = geo[5 * n + p];
  const float r = geo[6 * n + p], qx = geo[7 * n + p], qy = geo[8 * n + p],
              qz = geo[9 * n + p];
  const float alive = geo[10 * n + p];
  const float* V = cam.v;
  const float* FP = cam.v + 16;
  const float fx = cam.v[32], fy = cam.v[33];
  const float tan_fovx = cam.v[34], tan_fovy = cam.v[35];
  const float cpx = cam.v[36], cpy = cam.v[37], cpz = cam.v[38];

  const float tx = V[0] * x + V[1] * y + V[2] * z + V[3];
  const float ty = V[4] * x + V[5] * y + V[6] * z + V[7];
  const float tz = V[8] * x + V[9] * y + V[10] * z + V[11];
  const float depth = tz;

  const float hx = FP[0] * x + FP[1] * y + FP[2] * z + FP[3];
  const float hy = FP[4] * x + FP[5] * y + FP[6] * z + FP[7];
  const float hw = FP[12] * x + FP[13] * y + FP[14] * z + FP[15];
  const float inv_w = 1.0f / (hw + 1e-7f);
  const float mx = ((hx * inv_w + 1.0f) * (float)width - 1.0f) * 0.5f;
  const float my = ((hy * inv_w + 1.0f) * (float)height - 1.0f) * 0.5f;

  const float R00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float R01 = 2.0f * (qx * qy - r * qz);
  const float R02 = 2.0f * (qx * qz + r * qy);
  const float R10 = 2.0f * (qx * qy + r * qz);
  const float R11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float R12 = 2.0f * (qy * qz - r * qx);
  const float R20 = 2.0f * (qx * qz - r * qy);
  const float R21 = 2.0f * (qy * qz + r * qx);
  const float R22 = 1.0f - 2.0f * (qx * qx + qy * qy);

  // A = W @ (R diag(s)), W the view rotation
  float A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    A[i][0] = (V[4 * i + 0] * R00 + V[4 * i + 1] * R10 + V[4 * i + 2] * R20) * s0;
    A[i][1] = (V[4 * i + 0] * R01 + V[4 * i + 1] * R11 + V[4 * i + 2] * R21) * s1;
    A[i][2] = (V[4 * i + 0] * R02 + V[4 * i + 1] * R12 + V[4 * i + 2] * R22) * s2;
  }

  const float lim_x = 1.3f * tan_fovx;
  const float lim_y = 1.3f * tan_fovy;
  const float tz_safe = fabsf(tz) < 1e-6f ? 1e-6f : tz;
  const float cx = clampf(tx / tz_safe, -lim_x, lim_x) * tz_safe;
  const float cy = clampf(ty / tz_safe, -lim_y, lim_y) * tz_safe;
  const float j00 = fx / tz_safe;
  const float j02 = -(fx * cx) / (tz_safe * tz_safe);
  const float j11 = fy / tz_safe;
  const float j12 = -(fy * cy) / (tz_safe * tz_safe);
  const float m00 = j00 * A[0][0] + j02 * A[2][0];
  const float m01 = j00 * A[0][1] + j02 * A[2][1];
  const float m02 = j00 * A[0][2] + j02 * A[2][2];
  const float m10 = j11 * A[1][0] + j12 * A[2][0];
  const float m11 = j11 * A[1][1] + j12 * A[2][1];
  const float m12 = j11 * A[1][2] + j12 * A[2][2];

  const float a = m00 * m00 + m01 * m01 + m02 * m02 + low_pass;
  const float b = m00 * m10 + m01 * m11 + m02 * m12;
  const float c = m10 * m10 + m11 * m11 + m12 * m12 + low_pass;

  const float det = a * c - b * b;
  const float det_safe = det == 0.0f ? 1.0f : det;
  const float inv_det = 1.0f / det_safe;
  const float ca = c * inv_det, cb = -b * inv_det, cc = a * inv_det;

  const float mid = 0.5f * (a + c);
  const float disc = sqrtf(maxf_nan(mid * mid - det, 0.1f));
  float radius = ceilf(3.0f * sqrtf(maxf_nan(mid + disc, 0.0f)));

  const bool finite = isfinite(depth);
  const float validf = (depth > near && det != 0.0f && radius > 0.0f &&
                        alive > 0.0f && finite) ? 1.0f : 0.0f;
  radius = radius * validf;

  // SH colour at the normalized view direction
  float dx = x - cpx, dy = y - cpy, dz = z - cpz;
  const float inv_n = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz + 1e-24f);
  dx = dx * inv_n;
  dy = dy * inv_n;
  dz = dz * inv_n;
  const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
  const float xy = dx * dy, yz = dy * dz, xz = dx * dz;

  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    auto coef = [&](int k) { return sh[(size_t)(3 * k + ch) * n + p]; };
    float res = C0 * coef(0);
    if (DEG > 0) {
      res = res - C1 * dy * coef(1) + C1 * dz * coef(2) - C1 * dx * coef(3);
    }
    if (DEG > 1) {
      res = res
          + C2_0 * xy * coef(4)
          + C2_1 * yz * coef(5)
          + C2_2 * (2.0f * zz - xx - yy) * coef(6)
          + C2_3 * xz * coef(7)
          + C2_4 * (xx - yy) * coef(8);
    }
    if (DEG > 2) {
      res = res
          + C3_0 * dy * (3.0f * xx - yy) * coef(9)
          + C3_1 * xy * dz * coef(10)
          + C3_2 * dy * (4.0f * zz - xx - yy) * coef(11)
          + C3_3 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy) * coef(12)
          + C3_4 * dx * (4.0f * zz - xx - yy) * coef(13)
          + C3_5 * dz * (xx - yy) * coef(14)
          + C3_6 * dx * (xx - 3.0f * yy) * coef(15);
    }
    rgb[ch] = maxf_nan(res + 0.5f, 0.0f);
  }

  out[0 * n + p] = validf;
  out[1 * n + p] = mx;
  out[2 * n + p] = my;
  out[3 * n + p] = depth;
  out[4 * n + p] = ca;
  out[5 * n + p] = cb;
  out[6 * n + p] = cc;
  out[7 * n + p] = radius;
  out[8 * n + p] = rgb[0];
  out[9 * n + p] = rgb[1];
  out[10 * n + p] = rgb[2];
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
