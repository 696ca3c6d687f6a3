// The per-(entry, pixel) compositing math shared by K3 (forward) and K5
// (backward). entry_alpha() is the one place that decides whether an entry
// touches a pixel; its products and fused multiply-adds are written with
// round-to-nearest intrinsics, which nvcc neither contracts nor splits, so
// K3 and K5 take the same decision on the same floats whatever else the
// compiler fuses.
#pragma once

#include "common.cuh"

namespace sdpgs_comp {

// Gaussian value at pixel (px, py) for the payload row `pay` (xy, conic
// abc, opacity): power = -0.5 (a dx^2 + c dy^2) - b dx dy and
// alpha = min(alpha_max, op e^power). Returns false where K3 skips the
// entry (power > 0 or alpha < alpha_min).
struct EntryAlpha {
  float dx, dy, ex, alpha_raw, alpha;
};

SDPGS_DEVICE bool entry_alpha(float mx, float my, float ca, float cb, float cc, float op,
                              float px, float py, float alpha_min, float alpha_max,
                              EntryAlpha& ea) {
  ea.dx = mx - px;
  ea.dy = my - py;
  const float q = __fmaf_rn(__fmul_rn(ca, ea.dx), ea.dx,
                            __fmul_rn(__fmul_rn(cc, ea.dy), ea.dy));
  const float power = __fmaf_rn(-0.5f, q, -__fmul_rn(__fmul_rn(cb, ea.dx), ea.dy));
  if (power > 0.0f) return false;
  ea.ex = expf(power);
  ea.alpha_raw = __fmul_rn(op, ea.ex);
  ea.alpha = fminf(alpha_max, ea.alpha_raw);
  return !(ea.alpha < alpha_min);
}

// One step of the back-to-front sweep for a contributing entry (after
// entry_alpha returned true). On entry T is the transmittance just after
// this entry and S = sum over later contributors j of w_j (v_j . g) plus
// T_final g_T; both are advanced past the entry. grad receives dL/d of the
// entry's 13 payload floats (xy, conic abc, opacity, 7 values):
//   dL/dv = w g,  dL/dalpha = T_i (v . g) - S / (1 - alpha),
// and where alpha is not clamped at alpha_max, alpha = op e^power gives
// dL/dop = dL/dalpha e^power and dL/dpower = dL/dalpha alpha (JAX's
// not_clamped mask, composite_pallas.py:68,215-216). e^power <= 1 here, so
// no product of a zero gradient with an overflowed exponential can form.
SDPGS_DEVICE void entry_grad(const EntryAlpha& ea, float ca, float cb, float cc,
                             const float* v, const float* g, float alpha_max, float& T,
                             float& S, float* grad) {
  const float one_m = 1.0f - ea.alpha;
  const float t_i = T / one_m;
  const float w = ea.alpha * t_i;
  float vg = 0.0f;
  for (int ch = 0; ch < SDPGS_NCH; ++ch) {
    vg += v[ch] * g[ch];
    grad[6 + ch] = w * g[ch];
  }
  const float d_alpha = t_i * vg - S / one_m;
  S += w * vg;
  T = t_i;
  if (ea.alpha_raw < alpha_max) {
    const float d_pow = d_alpha * ea.alpha_raw;
    grad[0] = -d_pow * (ca * ea.dx + cb * ea.dy);
    grad[1] = -d_pow * (cc * ea.dy + cb * ea.dx);
    grad[2] = -0.5f * d_pow * ea.dx * ea.dx;
    grad[3] = -d_pow * ea.dx * ea.dy;
    grad[4] = -0.5f * d_pow * ea.dy * ea.dy;
    grad[5] = d_alpha * ea.ex;
  } else {
    for (int f = 0; f < 6; ++f) grad[f] = 0.0f;
  }
}

}  // namespace sdpgs_comp
