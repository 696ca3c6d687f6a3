// The per-(entry, pixel) compositing math shared by K3 (forward) and K5
// (backward). entry_alpha() is the one place that decides whether an entry
// touches a pixel; its products and fused multiply-adds are written with
// round-to-nearest intrinsics, which nvcc neither contracts nor splits, so
// K3 and K5 take the same decision on the same floats whatever else the
// compiler fuses. entry_box() bounds where that decision can be true, so
// both kernels skip an entry for a warp's pixel patch its box misses.
//
// Why entry_box is exact (no pixel that entry_alpha passes is skipped).
// With u = 2^-24 and d = (mx - px, my - py) exactly, entry_alpha's power,
// -0.5 (a dx^2 + c dy^2) - b dx dy = -Q(d) / 2, is formed with at most six
// roundings on each term (dx and dy themselves, products, fma, sum), so
// the computed power p' differs from the exact p by less than
// 7u (|a| dx^2 / 2 + |c| dy^2 / 2 + |b dx dy|), provided nothing
// overflows: that holds for |mean|, pixel coordinates <= 2^20 and
// |a|, |b|, |c| <= 2^40 (terms below 2^82). A pair passes only if
// alpha >= alpha_min >= 1e-20, and alpha <= op e^p' (1 + 3e-7) (expf to 2
// ulp, one rounded product; e^p' is not subnormal there, as op <= 2^20;
// a NaN cannot form with finite inputs inside those bounds), so
// p' >= -tau - 3e-7 with tau = ln(op / alpha_min). Using
// 2 |dx dy| <= dx^2 + dy^2, passing implies Q'(d) <= 2 tau + 6e-7 for
// Q' = a' dx^2 + 2 b dx dy + c' dy^2, a' = a - kRel (|a| + |b|),
// c' = c - kRel (|c| + |b|), kRel = 1e-5 >= 7u. Where Q' is positive
// definite, Q'(d) <= r bounds |dx| <= sqrt(r c' / det') and
// |dy| <= sqrt(r a' / det'), det' = a' c' - b^2. entry_box computes these
// in double (b^2 exact, det' to 1e-7 relative as det' > 1e-9 a' c'), with
// r = 2 (max(tau, 0) + kSlack) + kSlack, widens them by 1e-6 relative and
// absolute, and rounds the box outward to float. Where op <= 0 the
// product op e^p' <= 0 < alpha_min: the box is empty. Any input outside
// the bounds, NaN or infinite, a Q' that is not positive definite, or
// alpha_min < 1e-20 gives the whole plane (no skip). On the card,
// chip_smoke.py holds K3's n_visit and last_contrib at every pixel, and
// K3's and K5's contributing-pair counts, to a plain sequential walk of
// every entry;
// tests/test_torch_composite_cull.py mirrors the box on the CPU and checks
// its constants against this file.
#pragma once

#include "common.cuh"

namespace sdpgs_comp {

// entry_box's bounds on its inputs (no float overflow in entry_alpha within
// them) and its margins (see the note at the top).
constexpr float kMaxCoord = 1048576.0f;     // 2^20: |mean|, and pixel coordinates
constexpr float kMaxConic = 1099511627776.0f;  // 2^40: |a|, |b|, |c|
constexpr double kRel = 1e-5;               // >= 7u, the rounding of power
constexpr double kSlack = 1e-5;             // >= 3e-7, exp and op * e^power
constexpr double kMinDet = 1e-9;            // det' / (a' c'): det' known to 1e-7
constexpr float kMinAlpha = 1e-20f;         // alpha_min: e^power not subnormal
constexpr unsigned kFullMask = 0xffffffffu;

template <typename V>
SDPGS_DEVICE V warp_sum(V v) {  // lane 0 gets the warp's sum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

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
  // every rounding step is an intrinsic, so no contraction the compiler
  // chooses for one instance of K5 (with or without stats) changes a bit
  const float one_m = __fsub_rn(1.0f, ea.alpha);
  const float t_i = __fdiv_rn(T, one_m);
  const float w = __fmul_rn(ea.alpha, t_i);
  float vg = 0.0f;
  for (int ch = 0; ch < SDPGS_NCH; ++ch) {
    vg = __fmaf_rn(v[ch], g[ch], vg);
    grad[6 + ch] = __fmul_rn(w, g[ch]);
  }
  const float d_alpha = __fsub_rn(__fmul_rn(t_i, vg), __fdiv_rn(S, one_m));
  S = __fmaf_rn(w, vg, S);
  T = t_i;
  if (ea.alpha_raw < alpha_max) {
    const float d_pow = __fmul_rn(d_alpha, ea.alpha_raw);
    grad[0] = -__fmul_rn(d_pow, __fmaf_rn(ca, ea.dx, __fmul_rn(cb, ea.dy)));
    grad[1] = -__fmul_rn(d_pow, __fmaf_rn(cc, ea.dy, __fmul_rn(cb, ea.dx)));
    grad[2] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, d_pow), ea.dx), ea.dx);
    grad[3] = __fmul_rn(__fmul_rn(-d_pow, ea.dx), ea.dy);
    grad[4] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, d_pow), ea.dy), ea.dy);
    grad[5] = __fmul_rn(d_alpha, ea.ex);
  } else {
    for (int f = 0; f < 6; ++f) grad[f] = 0.0f;
  }
}

// An entry's pixel box: every pixel centre at which entry_alpha can return
// true lies in [x0, x1] x [y0, y1]. The whole plane where no bound is
// proven, an empty box where no pixel can pass.
struct __align__(16) Box {
  float x0, x1, y0, y1;
};

SDPGS_DEVICE Box entry_box(float mx, float my, float a, float b, float c, float op,
                           float alpha_min) {
  const Box all{-INFINITY, INFINITY, -INFINITY, INFINITY};
  if (!(fabsf(mx) <= kMaxCoord && fabsf(my) <= kMaxCoord && fabsf(a) <= kMaxConic &&
        fabsf(b) <= kMaxConic && fabsf(c) <= kMaxConic && fabsf(op) <= kMaxCoord)) {
    return all;  // also every NaN
  }
  if (op <= 0.0f) return Box{INFINITY, -INFINITY, INFINITY, -INFINITY};
  const double ad = a, bd = b, cd = c;
  const double ap = ad - kRel * (fabs(ad) + fabs(bd));
  const double cp = cd - kRel * (fabs(cd) + fabs(bd));
  const double det = ap * cp - bd * bd;
  if (!(ap > 0.0 && cp > 0.0 && det > kMinDet * ap * cp)) return all;
  const double tau = fmax(log(static_cast<double>(op) / alpha_min), 0.0) + kSlack;
  const double r = 2.0 * tau + kSlack;
  const double hx = sqrt(r * cp / det) * (1.0 + 1e-6) + 1e-6;
  const double hy = sqrt(r * ap / det) * (1.0 + 1e-6) + 1e-6;
  return Box{__double2float_rd(mx - hx), __double2float_ru(mx + hx),
             __double2float_rd(my - hy), __double2float_ru(my + hy)};
}

// Whether box `bx` meets the pixel centres [x0, x1] x [y0, y1].
SDPGS_DEVICE bool box_meets(const Box& bx, float x0, float x1, float y0, float y1) {
  return x0 <= bx.x1 && x1 >= bx.x0 && y0 <= bx.y1 && y1 >= bx.y0;
}

// Whether entry_box's proof holds for this launch: pixel coordinates within
// kMaxCoord and alpha_min >= kMinAlpha. num_tiles is the grid's, also where
// a launch takes a range of its tiles. Where it does not, the kernels walk
// every entry.
inline bool cull_holds(int tiles_x, int num_tiles, int tile, float alpha_min) {
  const int tiles_y = (num_tiles + tiles_x - 1) / tiles_x;
  return alpha_min >= kMinAlpha && static_cast<double>(tiles_x) * tile <= kMaxCoord &&
         static_cast<double>(tiles_y) * tile <= kMaxCoord;
}

// K3's and K5's blocks where 8 divides the tile: a tile whose side 16
// divides is split into 16x16 squares, a tile of 8 or 24 is one square;
// one block per square, one 8x4 pixel patch per warp.
constexpr int kSquare = 16;
constexpr int kPatchW = 8;      // one warp's pixels: kPatchW x kPatchH
constexpr int kPatchH = 4;
constexpr int kMaxThreads = 24 * 24;  // the largest block: a 24x24 tile
static_assert(kPatchW * kPatchH == 32, "a warp's patch");

inline int square_side(int tile) { return tile % kSquare == 0 ? kSquare : tile; }

// The pixel (lx, ly) of the tile that `lane` of `warp` takes in square
// `part` (row-major over the tile's squares, patches row-major in a square).
SDPGS_DEVICE void patch_pixel(int part, int warp, int lane, int tile, int square, int& lx,
                              int& ly) {
  const int squares_x = tile / square;
  const int patches_x = square / kPatchW;
  lx = (part % squares_x) * square + (warp % patches_x) * kPatchW + lane % kPatchW;
  ly = (part / squares_x) * square + (warp / patches_x) * kPatchH + lane / kPatchW;
}

}  // namespace sdpgs_comp
