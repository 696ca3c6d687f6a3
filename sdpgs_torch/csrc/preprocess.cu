// K1: fused per-Gaussian preprocess + SH colour, forward, into the
// compositor's payload.
//
// Replaces sdpgs_tpu/ops/rasterize/preprocess_pallas.py:_fwd_kernel (the
// pl.pallas_call at :227, reached through preprocess_color_pallas). For each
// Gaussian: world->view, projection to pixels, quaternion+scale -> EWA 2D
// covariance (+low-pass) -> conic, 3-sigma radius, culling (near plane,
// det, alive, finite depth), and SH degree 0..3 -> RGB (+0.5, clamped at 0);
// then the Gaussian's [13] payload row (ops/rasterize/payload.py: mean2d
// plus the screen offset, conic, opacity * valid, rgb or the caller's
// colour, depth, feature) and the binning record (mean2d, depth, radius,
// valid). Row P of the payload is the zero sentinel.
//
// Bound on the H100: bytes. Each Gaussian reads 65 floats at degree 3 (xyz,
// scale, quat, 48 SH, alive, opacity, feature, offset) and writes the 13-
// float row, 4 floats of the record and a byte: ~330 bytes for a few
// hundred flops, far below the card's ~20 flop/byte f32 ridge.
//
// Design: the inputs are the Gaussians' own row-major tensors, read in
// place. A block of kThreads threads owns kThreads consecutive slots, which
// are one contiguous span of every [P, k] tensor: the block stages the SH
// rows (12 + 180 bytes a slot) into shared memory with 16-byte loads, each
// thread computes from its staged row, writes its payload row to shared
// memory, and the block stores the rows as one span with 16-byte stores.
// The small rows (xyz, scale, quat, feature, offset) and the [P] arrays
// are read and written by their own thread; a warp's accesses to them fall
// in a few lines. Every thread issues all its loads, staged and small,
// before its first wait (preprocess_math.cuh:Rows): with the loads of a
// staging loop issued one after another the first design took 1.28x the
// bytes bound at 2^22 slots, 1.08x with them in flight together. The
// 39-float camera rides in the kernel's parameter space. The arithmetic lives in preprocess_math.cuh, shared with K4, and
// copies the plain version (preprocess_cuda.py:_row_math) operation by
// operation; the file is built with -fmad=false and IEEE division/sqrt, so
// each float op rounds as the plain PyTorch ops do and the step functions
// (radius = ceil(...), valid) agree with it exactly.

#include "preprocess_math.cuh"

namespace {

using sdpgs_pp::CamVec;

constexpr int kThreads = 128;

struct In {
  const float *xyz, *scale, *quat, *dc, *rest, *alive, *opacity, *feature;
  const float* color;   // [P, 3] or null: the SH colour
  const float* offset;  // [P, 2] or null
  int rest_stride;      // floats a features_rest row
};

struct Out {
  float* rows;      // [P + 1, NPAY]
  float* mean2d;    // [P, 2]
  float* depth;     // [P]
  float* radius;    // [P]
  uint8_t* valid;   // [P] bool
};

template <int DEG>
__global__ void __launch_bounds__(kThreads)
preprocess_fwd_kernel(In in, Out out, int P, CamVec cam, int width, int height,
                      float near, float low_pass) {
  constexpr int NREST = (DEG + 1) * (DEG + 1) - 1;
  constexpr int WREST = 3 * NREST;
  __shared__ __align__(16) float s_dc[kThreads * 3];
  __shared__ __align__(16) float s_rest[kThreads * (WREST > 0 ? WREST : 1)];
  __shared__ __align__(16) float s_row[kThreads * SDPGS_NPAY];
  const int p0 = blockIdx.x * kThreads;
  const int n = min(kThreads, P - p0);           // this block's Gaussians (0 past P)
  const int n_rows = min(kThreads, P + 1 - p0);  // its payload rows, the sentinel's too
  const int t = threadIdx.x;
  const int p = p0 + t;
  const size_t q = (size_t)p;
  // every load in flight before the first wait: the staged SH rows and the
  // thread's own small rows
  sdpgs_pp::Rows<3, kThreads> dc;
  sdpgs_pp::Rows<WREST, kThreads> rest;
  dc.load(in.dc, 3, p0, n);
  rest.load(in.rest, in.rest_stride, p0, n);
  sdpgs_pp::Geo g{};
  float opacity = 0.0f, feat[3] = {0.0f, 0.0f, 0.0f}, off[2] = {0.0f, 0.0f};
  if (p < P) {
    g = sdpgs_pp::Geo{in.xyz[3 * q], in.xyz[3 * q + 1], in.xyz[3 * q + 2],
                      in.scale[3 * q], in.scale[3 * q + 1], in.scale[3 * q + 2],
                      in.quat[4 * q], in.quat[4 * q + 1], in.quat[4 * q + 2],
                      in.quat[4 * q + 3], in.alive[q]};
    opacity = in.opacity[q];
    for (int c = 0; c < 3; ++c) feat[c] = in.feature[3 * q + c];
    if (in.offset != nullptr) {
      off[0] = in.offset[2 * q];
      off[1] = in.offset[2 * q + 1];
    }
  }
  dc.store(s_dc, in.dc, 3, p0, n);
  rest.store(s_rest, in.rest, in.rest_stride, p0, n);
  __syncthreads();

  float* row = s_row + t * SDPGS_NPAY;
  if (p < P) {
    sdpgs_pp::Fwd f;
    sdpgs_pp::forward<DEG>(g, sdpgs_pp::ShRow{s_dc + 3 * t, s_rest + WREST * t}, cam,
                           width, height, near, low_pass, f);
    float mx = f.mx, my = f.my;
    if (in.offset != nullptr) {
      mx = mx + off[0];
      my = my + off[1];
    }
    row[SDPGS_PAY_MEAN2D] = mx;
    row[SDPGS_PAY_MEAN2D + 1] = my;
    row[SDPGS_PAY_CONIC] = f.ca;
    row[SDPGS_PAY_CONIC + 1] = f.cb;
    row[SDPGS_PAY_CONIC + 2] = f.cc;
    row[SDPGS_PAY_OPACITY] = opacity * f.validf;
    for (int ch = 0; ch < 3; ++ch) {
      row[SDPGS_PAY_RGB + ch] = in.color != nullptr ? in.color[3 * q + ch] : f.rgb[ch];
      row[SDPGS_PAY_FEATURE + ch] = feat[ch];
    }
    row[SDPGS_PAY_DEPTH] = f.tz;
    reinterpret_cast<float2*>(out.mean2d)[q] = make_float2(mx, my);
    out.depth[q] = f.tz;
    out.radius[q] = f.radius;
    out.valid[q] = f.validf > 0.0f ? 1 : 0;
  } else if (p == P) {
    for (int c = 0; c < SDPGS_NPAY; ++c) row[c] = 0.0f;
  }
  __syncthreads();
  sdpgs_pp::stage_out<SDPGS_NPAY, kThreads>(out.rows, SDPGS_NPAY, s_row, p0, n_rows);
}

}  // namespace

SDPGS_API const char* sdpgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Inputs (f32, device, contiguous): xyz [P,3], scale [P,3], quat [P,4],
// dc [P,1,3], rest [P,rest_stride/3,3], alive [P], opacity [P], feature
// [P,3]; color [P,3] and offset [P,2] or null. Outputs: rows [P+1,13],
// mean2d [P,2], depth [P], radius [P] f32 and valid [P] bool. cam: host
// pointer to the 39-float camera vector (copied into the launch).
SDPGS_API int sdpgs_preprocess_fwd(const float* xyz, const float* scale, const float* quat,
                                   const float* dc, const float* rest, int rest_stride,
                                   const float* alive, const float* opacity,
                                   const float* feature, const float* color,
                                   const float* offset, const float* cam, float* rows,
                                   float* mean2d, float* depth, float* radius,
                                   unsigned char* valid, int P, int deg, int width,
                                   int height, float near, float low_pass, void* stream) {
  CamVec cv;
  for (int i = 0; i < 39; ++i) cv.v[i] = cam[i];
  const In in{xyz, scale, quat, dc, rest, alive, opacity, feature, color, offset, rest_stride};
  const Out out{rows, mean2d, depth, radius, valid};
  const int blocks = (P + 1 + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDPGS_PP_FWD(D) \
  preprocess_fwd_kernel<D><<<blocks, kThreads, 0, s>>>(in, out, P, cv, width, height, near, low_pass)
  switch (deg) {
    case 0: SDPGS_PP_FWD(0); break;
    case 1: SDPGS_PP_FWD(1); break;
    case 2: SDPGS_PP_FWD(2); break;
    case 3: SDPGS_PP_FWD(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SDPGS_PP_FWD
  return static_cast<int>(cudaGetLastError());
}
