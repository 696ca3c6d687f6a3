// K4: fused per-Gaussian preprocess + SH colour, backward (vjp), from the
// payload's gradient to each field's.
//
// Replaces sdpgs_tpu/ops/rasterize/preprocess_pallas.py:_bwd_kernel (the
// pl.pallas_call at :236, reached through the custom vjp of _pp_rows). The
// TPU kernel traces jax.vjp of the row math into the kernel; here the vjp
// is written by hand (preprocess_math.cuh:backward), as the reference does
// in backward.cu:144-396: screen centre and depth -> xyz, conic -> 2D
// covariance -> (J, W, R, S) -> normalized quaternion and activated scale,
// SH colour -> coefficients and, through the normalized view direction,
// xyz. It takes the gradient of K1's [P+1, 13] payload as K5 leaves it and
// writes each field's gradient in that field's own shape: d xyz, d scale,
// d quat (as [4, P] rows), d features_dc, d features_rest (0 past the
// active degree),
// d opacity (= g_opacity * valid), d feature, and where the caller passed
// them d offset (= g_mean2d) and d colour (= g_rgb; the SH then get none).
//
// Bound on the H100: bytes. Each Gaussian reads 72 floats at degree 3
// (xyz, scale, quat, 48 SH, alive, the 13-float payload gradient) and
// writes 64 (10 geometry, 48 SH, opacity, feature, offset): 544 bytes for a
// few hundred flops, far below the card's f32 ridge.
//
// Design: K1's. A block of kThreads threads owns kThreads consecutive
// slots; it stages their SH rows and payload-gradient rows into shared
// memory with 16-byte loads, all issued before the first wait (1.81x the
// bytes bound at 2^22 slots one after another, 1.12x together), each
// thread recomputes its Gaussian's forward
// in registers with the very code K1 runs (preprocess_math.cuh:forward) and
// writes its features_rest gradient over its staged coefficients (the
// backward calls dsh after the last read of each), and the block stores
// those 180-byte rows as one span with 16-byte stores. The file is built
// with -fmad=false like K1, so every mask the gradient passes through (the
// clip of tx/tz and ty/tz, the tz_safe and det_safe substitutions, the rgb
// clamp at 0) is decided on the same floats as in K1 and in the plain
// version; with a non-null `masks` the kernel writes each Gaussian's mask
// word for that check.

#include "preprocess_math.cuh"

namespace {

using sdpgs_pp::CamVec;

constexpr int kThreads = 128;

struct In {
  const float *xyz, *scale, *quat, *dc, *rest, *alive;
  const float* d_rows;  // [P + 1, NPAY]
  int rest_stride;
  bool color;           // the payload's rgb came from the caller's colour
};

struct Out {
  float *d_xyz, *d_scale;
  float* d_quat;    // [4, P] rows (see the launcher)
  float *d_dc, *d_rest, *d_opacity, *d_feature;
  float* d_offset;  // [P, 2] or null
  float* d_color;   // [P, 3] or null
  int* masks;       // [P] or null
};

// The SH gradient: coefficient 0 to the thread's features_dc row in device
// memory, the rest over the staged coefficients.
struct DShRow {
  float* dc;
  float* rest;
  SDPGS_DEVICE void operator()(int k, int ch, float v) const {
    if (k == 0) {
      dc[ch] = v;
    } else {
      rest[3 * (k - 1) + ch] = v;
    }
  }
};

template <int DEG>
__global__ void __launch_bounds__(kThreads)
preprocess_bwd_kernel(In in, Out out, int P, CamVec cam, int width, int height, float near,
                      float low_pass) {
  constexpr int NREST = (DEG + 1) * (DEG + 1) - 1;
  constexpr int WREST = 3 * NREST;
  __shared__ __align__(16) float s_dc[kThreads * 3];
  __shared__ __align__(16) float s_rest[kThreads * (WREST > 0 ? WREST : 1)];
  __shared__ __align__(16) float s_grad[kThreads * SDPGS_NPAY];
  const int p0 = blockIdx.x * kThreads;
  const int n = min(kThreads, P - p0);
  const int t = threadIdx.x;
  const int p = p0 + t;
  const size_t q = (size_t)p;
  // every load in flight before the first wait
  sdpgs_pp::Rows<3, kThreads> dc;
  sdpgs_pp::Rows<WREST, kThreads> rest;
  sdpgs_pp::Rows<SDPGS_NPAY, kThreads> grad;
  dc.load(in.dc, 3, p0, n);
  rest.load(in.rest, in.rest_stride, p0, n);
  grad.load(in.d_rows, SDPGS_NPAY, p0, n);
  sdpgs_pp::Geo g{};
  if (p < P) {
    g = sdpgs_pp::Geo{in.xyz[3 * q], in.xyz[3 * q + 1], in.xyz[3 * q + 2],
                      in.scale[3 * q], in.scale[3 * q + 1], in.scale[3 * q + 2],
                      in.quat[4 * q], in.quat[4 * q + 1], in.quat[4 * q + 2],
                      in.quat[4 * q + 3], in.alive[q]};
  }
  dc.store(s_dc, in.dc, 3, p0, n);
  rest.store(s_rest, in.rest, in.rest_stride, p0, n);
  grad.store(s_grad, in.d_rows, SDPGS_NPAY, p0, n);
  __syncthreads();

  if (p < P) {
    const float* gp = s_grad + t * SDPGS_NPAY;
    sdpgs_pp::Cot ct{gp[SDPGS_PAY_MEAN2D], gp[SDPGS_PAY_MEAN2D + 1], gp[SDPGS_PAY_DEPTH],
                     gp[SDPGS_PAY_CONIC], gp[SDPGS_PAY_CONIC + 1], gp[SDPGS_PAY_CONIC + 2],
                     {0.0f, 0.0f, 0.0f}};
    if (!in.color) {
      for (int ch = 0; ch < 3; ++ch) ct.rgb[ch] = gp[SDPGS_PAY_RGB + ch];
    }
    float dg[10];
    float validf;
    const int mask = sdpgs_pp::backward<DEG>(
        g, sdpgs_pp::ShRow{s_dc + 3 * t, s_rest + WREST * t}, ct, cam, width, height, near,
        low_pass, dg, DShRow{out.d_dc + 3 * q, s_rest + WREST * t}, &validf);
    for (int i = 0; i < 3; ++i) {
      out.d_xyz[3 * q + i] = dg[i];
      out.d_scale[3 * q + i] = dg[3 + i];
      out.d_feature[3 * q + i] = gp[SDPGS_PAY_FEATURE + i];
    }
    for (int i = 0; i < 4; ++i) out.d_quat[(size_t)i * P + q] = dg[6 + i];
    out.d_opacity[q] = gp[SDPGS_PAY_OPACITY] * validf;
    if (out.d_offset != nullptr) {
      reinterpret_cast<float2*>(out.d_offset)[q] =
          make_float2(gp[SDPGS_PAY_MEAN2D], gp[SDPGS_PAY_MEAN2D + 1]);
    }
    if (out.d_color != nullptr) {
      for (int ch = 0; ch < 3; ++ch) out.d_color[3 * q + ch] = gp[SDPGS_PAY_RGB + ch];
    }
    if (out.masks != nullptr) out.masks[q] = mask;
  }
  __syncthreads();
  sdpgs_pp::stage_out<WREST, kThreads>(out.d_rest, in.rest_stride, s_rest, p0, n);
}

}  // namespace

// Inputs (f32, device, contiguous): xyz [P,3], scale [P,3], quat [P,4],
// dc [P,1,3], rest [P,rest_stride/3,3], alive [P], d_rows [P+1,13];
// color: whether the payload's rgb was the caller's colour. Outputs, each
// in its input's shape but d_quat: d_xyz, d_scale, d_quat as [4,P] rows,
// d_dc, d_rest, d_opacity [P], d_feature [P,3]; d_offset [P,2], d_color
// [P,3] and masks [P] int32, each or null. cam: host pointer to the
// 39-float camera vector. d_quat is handed on as the transpose of its rows,
// the layout the plain version's chain gives it: the normalized
// quaternion's backward sums over its four components, and PyTorch rounds
// that sum differently when the gradient's last dimension is packed.
SDPGS_API int sdpgs_preprocess_bwd(const float* xyz, const float* scale, const float* quat,
                                   const float* dc, const float* rest, int rest_stride,
                                   const float* alive, const float* d_rows, int color,
                                   const float* cam, float* d_xyz, float* d_scale,
                                   float* d_quat, float* d_dc, float* d_rest,
                                   float* d_opacity, float* d_feature, float* d_offset,
                                   float* d_color, int* masks, int P, int deg, int width,
                                   int height, float near, float low_pass, void* stream) {
  CamVec cv;
  for (int i = 0; i < 39; ++i) cv.v[i] = cam[i];
  if (P == 0) return 0;
  const In in{xyz, scale, quat, dc, rest, alive, d_rows, rest_stride, color != 0};
  const Out out{d_xyz, d_scale, d_quat, d_dc, d_rest, d_opacity, d_feature, d_offset,
                d_color, masks};
  const int blocks = (P + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDPGS_PP_BWD(D) \
  preprocess_bwd_kernel<D><<<blocks, kThreads, 0, s>>>(in, out, P, cv, width, height, near, low_pass)
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
