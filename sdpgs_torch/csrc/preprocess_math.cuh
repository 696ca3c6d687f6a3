// The per-Gaussian preprocess + SH chain shared by K1 (forward) and K4
// (backward, vjp by hand): one copy of the forward arithmetic, so K4 recomputes exactly
// the quantities, and the step-function masks, that K1 computed. Both
// files are built with -fmad=false; the arithmetic copies the plain
// version (preprocess_cuda.py:_row_math) operation by operation, in the
// same association order, with IEEE division and sqrt. The math takes one
// Gaussian's values (Geo, an SH accessor, Cot) and knows no layout; the
// staging helpers below move a block's rows between the Gaussians' own
// row-major tensors and shared memory.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace sdpgs_pp {

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
SDPGS_DEVICE float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
SDPGS_DEVICE float maxf_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// One Gaussian's geometry: position, activated scale, normalized
// quaternion (w, x, y, z) and the alive flag.
struct Geo {
  float x, y, z, s0, s1, s2, r, qx, qy, qz, alive;
};

// One Gaussian's SH coefficients where a block staged them: coefficient 0
// from features_dc, 1.. from features_rest. sh(k, ch).
struct ShRow {
  const float* dc;    // 3 floats
  const float* rest;  // 3 per coefficient past the first
  SDPGS_DEVICE float operator()(int k, int ch) const {
    return k == 0 ? dc[ch] : rest[3 * (k - 1) + ch];
  }
};

// The cotangents of the outputs that carry a gradient: the screen centre,
// depth, conic and the three colour channels (0 where the colour is
// another tensor's).
struct Cot {
  float mx, my, depth, ca, cb, cc, rgb[3];
};

// Staging a block's rows between a row-major [*, stride] f32 tensor and
// shared memory s[r * W + c] (16-byte aligned), W floats a row. A block of
// T threads owns rows [r0, r0 + n). Where the block is whole (n == T), the
// rows are packed (stride == W) and the span is 16-byte aligned, the span
// moves in 16-byte accesses, each thread's loads all issued before its
// first store (Rows::load, then Rows::store); else one float at a time
// (a block's last rows, features_rest past the active degree).
template <int W>
SDPGS_DEVICE void stage_in_floats(float* s, const float* src, int stride, int r0, int n) {
  if constexpr (W > 0) {
    for (int i = threadIdx.x; i < n * W; i += blockDim.x) {
      const int r = i / W;
      s[i] = src[(size_t)(r0 + r) * stride + (i - r * W)];
    }
  }
}

template <int W, int T>
struct Rows {
  static_assert(T % 4 == 0, "a whole block's span is whole float4s");
  static constexpr int N4 = W * T / 4;
  static constexpr int PER = (N4 + T - 1) / T;
  float4 v[PER > 0 ? PER : 1];
  bool fast;

  SDPGS_DEVICE void load(const float* src, int stride, int r0, int n) {
    const float* g = src + (size_t)r0 * stride;
    fast = W > 0 && n == T && stride == W && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    if (fast) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = threadIdx.x + j * T;
        if (i < N4) v[j] = g4[i];
      }
    }
  }

  SDPGS_DEVICE void store(float* s, const float* src, int stride, int r0, int n) const {
    if (fast) {
      float4* s4 = reinterpret_cast<float4*>(s);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = threadIdx.x + j * T;
        if (i < N4) s4[i] = v[j];
      }
    } else if (n > 0) {
      stage_in_floats<W>(s, src, stride, r0, n);
    }
  }
};

// The inverse of Rows: rows [r0, r0 + n) of dst from s[r * W + c], the
// columns past W written 0.
template <int W, int T>
SDPGS_DEVICE void stage_out(float* dst, int stride, const float* s, int r0, int n) {
  float* g = dst + (size_t)r0 * stride;
  if (n == T && stride == W && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    constexpr int N4 = W * T / 4;
    float4* g4 = reinterpret_cast<float4*>(g);
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int j = 0; j < (N4 + T - 1) / T; ++j) {
      const int i = threadIdx.x + j * T;
      if (i < N4) g4[i] = s4[i];
    }
  } else {
    for (int i = threadIdx.x; i < n * stride; i += blockDim.x) {
      const int r = i / stride;
      const int c = i - r * stride;
      dst[(size_t)(r0 + r) * stride + c] = c < W ? s[r * W + c] : 0.0f;
    }
  }
}

// Everything the forward computes for one Gaussian that the backward
// reads again.
struct Fwd {
  float x, y, z, s0, s1, s2, r, qx, qy, qz;
  float tx, ty, tz, hx, hy, inv_w, mx, my;
  float R[3][3];
  float B[3][3];  // W @ R, before the scale
  float A[3][3];  // W @ R @ diag(s)
  float lim_x, lim_y, tz_safe, ux, uy, cx, cy, j00, j02, j11, j12;
  float m0[3], m1[3];
  float a, b, c, det, inv_det, ca, cb, cc, radius, validf;
  float vx, vy, vz, inv_n, dx, dy, dz;  // view vector, 1/|v|, direction
  float res[3], rgb[3];
};

// One Gaussian: geometry g, SH coefficients sh(k, ch) for k < (DEG+1)^2.
template <int DEG, class SH>
SDPGS_DEVICE void forward(const Geo& g, const SH& sh, const CamVec& cam, int width,
                          int height, float near, float low_pass, Fwd& f) {
  f.x = g.x;
  f.y = g.y;
  f.z = g.z;
  f.s0 = g.s0;
  f.s1 = g.s1;
  f.s2 = g.s2;
  f.r = g.r;
  f.qx = g.qx;
  f.qy = g.qy;
  f.qz = g.qz;
  const float alive = g.alive;
  const float x = f.x, y = f.y, z = f.z;
  const float r = f.r, qx = f.qx, qy = f.qy, qz = f.qz;
  const float* V = cam.v;
  const float* FP = cam.v + 16;
  const float fx = cam.v[32], fy = cam.v[33];
  const float tan_fovx = cam.v[34], tan_fovy = cam.v[35];
  const float cpx = cam.v[36], cpy = cam.v[37], cpz = cam.v[38];

  f.tx = V[0] * x + V[1] * y + V[2] * z + V[3];
  f.ty = V[4] * x + V[5] * y + V[6] * z + V[7];
  f.tz = V[8] * x + V[9] * y + V[10] * z + V[11];
  const float depth = f.tz;

  f.hx = FP[0] * x + FP[1] * y + FP[2] * z + FP[3];
  f.hy = FP[4] * x + FP[5] * y + FP[6] * z + FP[7];
  const float hw = FP[12] * x + FP[13] * y + FP[14] * z + FP[15];
  f.inv_w = 1.0f / (hw + 1e-7f);
  f.mx = ((f.hx * f.inv_w + 1.0f) * (float)width - 1.0f) * 0.5f;
  f.my = ((f.hy * f.inv_w + 1.0f) * (float)height - 1.0f) * 0.5f;

  f.R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  f.R[0][1] = 2.0f * (qx * qy - r * qz);
  f.R[0][2] = 2.0f * (qx * qz + r * qy);
  f.R[1][0] = 2.0f * (qx * qy + r * qz);
  f.R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  f.R[1][2] = 2.0f * (qy * qz - r * qx);
  f.R[2][0] = 2.0f * (qx * qz - r * qy);
  f.R[2][1] = 2.0f * (qy * qz + r * qx);
  f.R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);

  // A = W @ (R diag(s)), W the view rotation
  const float s[3] = {f.s0, f.s1, f.s2};
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      f.B[i][k] = V[4 * i + 0] * f.R[0][k] + V[4 * i + 1] * f.R[1][k] +
                  V[4 * i + 2] * f.R[2][k];
      f.A[i][k] = f.B[i][k] * s[k];
    }
  }

  f.lim_x = 1.3f * tan_fovx;
  f.lim_y = 1.3f * tan_fovy;
  const float tz = f.tz;
  f.tz_safe = fabsf(tz) < 1e-6f ? 1e-6f : tz;
  f.ux = f.tx / f.tz_safe;
  f.uy = f.ty / f.tz_safe;
  f.cx = clampf(f.ux, -f.lim_x, f.lim_x) * f.tz_safe;
  f.cy = clampf(f.uy, -f.lim_y, f.lim_y) * f.tz_safe;
  f.j00 = fx / f.tz_safe;
  f.j02 = -(fx * f.cx) / (f.tz_safe * f.tz_safe);
  f.j11 = fy / f.tz_safe;
  f.j12 = -(fy * f.cy) / (f.tz_safe * f.tz_safe);
  for (int k = 0; k < 3; ++k) {
    f.m0[k] = f.j00 * f.A[0][k] + f.j02 * f.A[2][k];
    f.m1[k] = f.j11 * f.A[1][k] + f.j12 * f.A[2][k];
  }

  f.a = f.m0[0] * f.m0[0] + f.m0[1] * f.m0[1] + f.m0[2] * f.m0[2] + low_pass;
  f.b = f.m0[0] * f.m1[0] + f.m0[1] * f.m1[1] + f.m0[2] * f.m1[2];
  f.c = f.m1[0] * f.m1[0] + f.m1[1] * f.m1[1] + f.m1[2] * f.m1[2] + low_pass;

  f.det = f.a * f.c - f.b * f.b;
  const float det_safe = f.det == 0.0f ? 1.0f : f.det;
  f.inv_det = 1.0f / det_safe;
  f.ca = f.c * f.inv_det;
  f.cb = -f.b * f.inv_det;
  f.cc = f.a * f.inv_det;

  const float mid = 0.5f * (f.a + f.c);
  const float disc = sqrtf(maxf_nan(mid * mid - f.det, 0.1f));
  float radius = ceilf(3.0f * sqrtf(maxf_nan(mid + disc, 0.0f)));

  const bool finite = isfinite(depth);
  f.validf = (depth > near && f.det != 0.0f && radius > 0.0f && alive > 0.0f &&
              finite) ? 1.0f : 0.0f;
  f.radius = radius * f.validf;

  // SH colour at the normalized view direction
  f.vx = x - cpx;
  f.vy = y - cpy;
  f.vz = z - cpz;
  f.inv_n = 1.0f / sqrtf(f.vx * f.vx + f.vy * f.vy + f.vz * f.vz + 1e-24f);
  f.dx = f.vx * f.inv_n;
  f.dy = f.vy * f.inv_n;
  f.dz = f.vz * f.inv_n;
  const float dx = f.dx, dy = f.dy, dz = f.dz;
  const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
  const float xy = dx * dy, yz = dy * dz, xz = dx * dz;

  for (int ch = 0; ch < 3; ++ch) {
    auto coef = [&](int k) { return sh(k, ch); };
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
    f.res[ch] = res + 0.5f;
    f.rgb[ch] = maxf_nan(f.res[ch], 0.0f);
  }
}

// Bits of the mask word backward() returns: the step functions the
// gradient passes through, for checking K4 against the plain version.
constexpr int kMaskClipX = 1;      // tx/tz inside [-lim_x, lim_x]
constexpr int kMaskClipY = 2;      // ty/tz inside [-lim_y, lim_y]
constexpr int kMaskTzSmall = 4;    // |tz| < 1e-6 (tz_safe substituted)
constexpr int kMaskDetZero = 8;    // det == 0 (det_safe substituted)
constexpr int kMaskRgb0 = 16;      // rgb channel c unclamped: bit 16 << c

// The vjp of forward() for one Gaussian at cotangent ct (valid and radius
// carry none): gradients into dgeo[10] (x y z, s0 s1 s2, r qx qy qz; alive
// has none) and, through dsh(k, ch, value), the SH coefficients; the
// forward's validity into *validf. dsh(k, ch, ...) is called after every
// read of sh(k, ch), so it may write where sh reads. The masks are those
// of the plain version's autograd: torch.clamp passes the gradient where
// the input lies inside the closed interval, clamp_min where it is >= the
// bound, torch.where only on its selected side. Returns the mask word.
template <int DEG, class SH, class DSH>
SDPGS_DEVICE int backward(const Geo& g, const SH& sh, const Cot& ct, const CamVec& cam,
                          int width, int height, float near, float low_pass, float* dgeo,
                          const DSH& dsh, float* validf) {
  Fwd f;
  forward<DEG>(g, sh, cam, width, height, near, low_pass, f);
  *validf = f.validf;
  const float* V = cam.v;
  const float* FP = cam.v + 16;
  const float fx = cam.v[32], fy = cam.v[33];
  const float g_mx = ct.mx, g_my = ct.my, g_depth = ct.depth;
  const float g_ca = ct.ca, g_cb = ct.cb, g_cc = ct.cc;
  int mask = 0;

  // pixel centre <- homogeneous projection
  const float d_ndx = g_mx * (0.5f * (float)width);
  const float d_ndy = g_my * (0.5f * (float)height);
  const float d_hx = d_ndx * f.inv_w;
  const float d_hy = d_ndy * f.inv_w;
  const float d_inv_w = d_ndx * f.hx + d_ndy * f.hy;
  const float d_hw = -d_inv_w * f.inv_w * f.inv_w;

  // conic <- 2D covariance (a, b, c)
  float d_a = g_cc * f.inv_det;
  float d_b = -(g_cb * f.inv_det);
  float d_c = g_ca * f.inv_det;
  const float d_inv_det = g_ca * f.c - g_cb * f.b + g_cc * f.a;
  float d_det = 0.0f;
  if (f.det == 0.0f) {
    mask |= kMaskDetZero;
  } else {
    d_det = -d_inv_det * f.inv_det * f.inv_det;
  }
  d_a += d_det * f.c;
  d_c += d_det * f.a;
  d_b -= 2.0f * f.b * d_det;

  // (a, b, c) <- M = J @ A, then J and A
  float d_j00 = 0.0f, d_j02 = 0.0f, d_j11 = 0.0f, d_j12 = 0.0f;
  float d_A[3][3];
  for (int k = 0; k < 3; ++k) {
    const float d_m0 = 2.0f * f.m0[k] * d_a + f.m1[k] * d_b;
    const float d_m1 = f.m0[k] * d_b + 2.0f * f.m1[k] * d_c;
    d_j00 += d_m0 * f.A[0][k];
    d_j02 += d_m0 * f.A[2][k];
    d_j11 += d_m1 * f.A[1][k];
    d_j12 += d_m1 * f.A[2][k];
    d_A[0][k] = d_m0 * f.j00;
    d_A[1][k] = d_m1 * f.j11;
    d_A[2][k] = d_m0 * f.j02 + d_m1 * f.j12;
  }

  // J <- tz_safe and the clipped centre (cx, cy)
  const float ts = f.tz_safe;
  const float ts2 = ts * ts;
  float d_ts = -(d_j00 * fx + d_j11 * fy) / ts2;
  d_ts += 2.0f * ts * (d_j02 * (fx * f.cx) + d_j12 * (fy * f.cy)) / (ts2 * ts2);
  const float d_cx = -(d_j02 * fx) / ts2;
  const float d_cy = -(d_j12 * fy) / ts2;
  d_ts += d_cx * clampf(f.ux, -f.lim_x, f.lim_x) + d_cy * clampf(f.uy, -f.lim_y, f.lim_y);
  float d_ux = 0.0f, d_uy = 0.0f;
  if (f.ux >= -f.lim_x && f.ux <= f.lim_x) {
    mask |= kMaskClipX;
    d_ux = d_cx * ts;
  }
  if (f.uy >= -f.lim_y && f.uy <= f.lim_y) {
    mask |= kMaskClipY;
    d_uy = d_cy * ts;
  }
  const float d_tx = d_ux / ts;
  const float d_ty = d_uy / ts;
  d_ts -= (d_ux * f.tx + d_uy * f.ty) / ts2;
  float d_tz = g_depth;
  if (fabsf(f.tz) < 1e-6f) {
    mask |= kMaskTzSmall;
  } else {
    d_tz += d_ts;
  }

  // A = (W @ R) diag(s) -> scale and rotation
  const float s[3] = {f.s0, f.s1, f.s2};
  float d_s[3] = {0.0f, 0.0f, 0.0f};
  float dR[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      d_s[k] += d_A[i][k] * f.B[i][k];
      const float d_B = d_A[i][k] * s[k];
      for (int j = 0; j < 3; ++j) dR[j][k] += V[4 * i + j] * d_B;
    }
  }
  const float r = f.r, qx = f.qx, qy = f.qy, qz = f.qz;
  const float d_r = 2.0f * (-qz * dR[0][1] + qy * dR[0][2] + qz * dR[1][0] -
                            qx * dR[1][2] - qy * dR[2][0] + qx * dR[2][1]);
  const float d_qx = 2.0f * (qy * dR[0][1] + qz * dR[0][2] + qy * dR[1][0] -
                             r * dR[1][2] + qz * dR[2][0] + r * dR[2][1]) -
                     4.0f * qx * (dR[1][1] + dR[2][2]);
  const float d_qy = 2.0f * (qx * dR[0][1] + r * dR[0][2] + qx * dR[1][0] +
                             qz * dR[1][2] - r * dR[2][0] + qz * dR[2][1]) -
                     4.0f * qy * (dR[0][0] + dR[2][2]);
  const float d_qz = 2.0f * (-r * dR[0][1] + qx * dR[0][2] + r * dR[1][0] +
                             qy * dR[1][2] + qx * dR[2][0] + qy * dR[2][1]) -
                     4.0f * qz * (dR[0][0] + dR[1][1]);

  // SH colour -> coefficients and view direction
  const float x = f.dx, y = f.dy, z = f.dz;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  constexpr int NB = (DEG + 1) * (DEG + 1);
  float basis[16];
  basis[0] = C0;
  if (DEG > 0) {
    basis[1] = -(C1 * y);
    basis[2] = C1 * z;
    basis[3] = -(C1 * x);
  }
  if (DEG > 1) {
    basis[4] = C2_0 * xy;
    basis[5] = C2_1 * yz;
    basis[6] = C2_2 * (2.0f * zz - xx - yy);
    basis[7] = C2_3 * xz;
    basis[8] = C2_4 * (xx - yy);
  }
  if (DEG > 2) {
    basis[9] = C3_0 * y * (3.0f * xx - yy);
    basis[10] = C3_1 * xy * z;
    basis[11] = C3_2 * y * (4.0f * zz - xx - yy);
    basis[12] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    basis[13] = C3_4 * x * (4.0f * zz - xx - yy);
    basis[14] = C3_5 * z * (xx - yy);
    basis[15] = C3_6 * x * (xx - 3.0f * yy);
  }
  float G[16];  // sum over channels of d_res * coefficient
  for (int k = 0; k < NB; ++k) G[k] = 0.0f;
  for (int ch = 0; ch < 3; ++ch) {
    float d_res = 0.0f;
    if (f.res[ch] >= 0.0f) {
      mask |= kMaskRgb0 << ch;
      d_res = ct.rgb[ch];
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      G[k] += d_res * sh(k, ch);
      dsh(k, ch, d_res * basis[k]);
    }
  }
  float d_x = 0.0f, d_y = 0.0f, d_z = 0.0f;
  if (DEG > 0) {
    d_x += -C1 * G[3];
    d_y += -C1 * G[1];
    d_z += C1 * G[2];
  }
  if (DEG > 1) {
    d_x += C2_0 * y * G[4] - 2.0f * C2_2 * x * G[6] + C2_3 * z * G[7] +
           2.0f * C2_4 * x * G[8];
    d_y += C2_0 * x * G[4] + C2_1 * z * G[5] - 2.0f * C2_2 * y * G[6] -
           2.0f * C2_4 * y * G[8];
    d_z += C2_1 * y * G[5] + 4.0f * C2_2 * z * G[6] + C2_3 * x * G[7];
  }
  if (DEG > 2) {
    d_x += 6.0f * C3_0 * xy * G[9] + C3_1 * yz * G[10] - 2.0f * C3_2 * xy * G[11] -
           6.0f * C3_3 * xz * G[12] + C3_4 * (4.0f * zz - 3.0f * xx - yy) * G[13] +
           2.0f * C3_5 * xz * G[14] + 3.0f * C3_6 * (xx - yy) * G[15];
    d_y += 3.0f * C3_0 * (xx - yy) * G[9] + C3_1 * xz * G[10] +
           C3_2 * (4.0f * zz - xx - 3.0f * yy) * G[11] - 6.0f * C3_3 * yz * G[12] -
           2.0f * C3_4 * xy * G[13] - 2.0f * C3_5 * yz * G[14] - 6.0f * C3_6 * xy * G[15];
    d_z += C3_1 * xy * G[10] + 8.0f * C3_2 * yz * G[11] +
           C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * G[12] + 8.0f * C3_4 * xz * G[13] +
           C3_5 * (xx - yy) * G[14];
  }
  // direction = v / sqrt(|v|^2 + 1e-24): d|v|^2 = -0.5 inv_n^3 (d_dir . v)
  const float d_inv_n = d_x * f.vx + d_y * f.vy + d_z * f.vz;
  const float d_n2 = -0.5f * f.inv_n * f.inv_n * f.inv_n * d_inv_n;
  const float d_vx = d_x * f.inv_n + 2.0f * f.vx * d_n2;
  const float d_vy = d_y * f.inv_n + 2.0f * f.vy * d_n2;
  const float d_vz = d_z * f.inv_n + 2.0f * f.vz * d_n2;

  dgeo[0] = V[0] * d_tx + V[4] * d_ty + V[8] * d_tz + FP[0] * d_hx + FP[4] * d_hy +
            FP[12] * d_hw + d_vx;
  dgeo[1] = V[1] * d_tx + V[5] * d_ty + V[9] * d_tz + FP[1] * d_hx + FP[5] * d_hy +
            FP[13] * d_hw + d_vy;
  dgeo[2] = V[2] * d_tx + V[6] * d_ty + V[10] * d_tz + FP[2] * d_hx + FP[6] * d_hy +
            FP[14] * d_hw + d_vz;
  dgeo[3] = d_s[0];
  dgeo[4] = d_s[1];
  dgeo[5] = d_s[2];
  dgeo[6] = d_r;
  dgeo[7] = d_qx;
  dgeo[8] = d_qy;
  dgeo[9] = d_qz;
  return mask;
}

}  // namespace sdpgs_pp
