// Fused Adam: one step for every trainable group of the Gaussians in one launch.
//
// Replaces no Pallas kernel: the JAX package's update (sdpgs_tpu/opt/adam.py:111-124) is
// plain jnp, which XLA fuses into one pass over each group. The port ran it as PyTorch's op
// chain (opt/adam.py:adam_update_plain): 14 elementwise launches a group, 98 a step, 33
// passes over the seven groups' 62 floats a slot.
//
// Bound on the H100: bytes. Per float the parameter, the gradient and both moments are read
// and the parameter and both moments written: 28 B, 62 floats a slot, 7.28 GB at 2^22 slots,
// 2.174 ms at 3.35 TB/s.
//
// Design:
// - One sweep. The launcher lays the groups' blocks back to back; a block serves one group
//   (it picks its descriptor with constant indices into the table, which stays in the
//   kernel's parameters: no copy to the device before the launch), a thread 4 floats. p, mu
//   and nu are dense, read and written 16 bytes a thread (a warp's accesses on 512
//   neighbouring bytes); a group whose dense rows are not 16-byte aligned, and each group's
//   last partial chunk, go float by float. This, the simplest layout, read 2.486 ms at 2^22
//   slots on the H100; 2-8 chunks a thread, 128 or 512 threads and loads hoisted ahead of
//   the arithmetic read 2.483-2.563, streaming cache hints 2.524-2.605.
// - Gradients are read in place, by their strides: autograd hands the features' gradients
//   over as narrow views of one [P, 16, 3] gradient and the geometry's as transposes of K4's
//   [NGEO, P] rows, and a copy would add back a pass. A row is [width / inner, inner] with
//   strides (g_mid, g_col), which covers every layout of a 2-d or 3-d gradient. Threads walk
//   the parameter's order, so a warp's gradient loads fall on a few runs of neighbouring
//   addresses (one per column of a transpose), served through L1.
// - Bit for bit with the op chain on the card: the same operations in the same order, each
//   rounded as its own launch rounds it (the _rn intrinsics, never contracted, and the file
//   is built with -fmad=false besides): m b1 + (1 - b1) g; v b2 + ((1 - b2) g) g; m (1/bc1)
//   and v (1/bc2), the reciprocals PyTorch takes of a CPU scalar divisor; IEEE sqrt, + eps,
//   IEEE divide; p - lr update. The launcher gets the scalars as PyTorch's kernels use them:
//   float32.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                          // floats a thread
constexpr int kBlockFloats = kThreads * kVec;    // 1,024
constexpr int kMaxGroups = 8;

}  // namespace

// One group, as the Python launcher builds it (opt/adam.py:AdamGroupC mirrors this layout).
struct SdpgsAdamGroup {
  float* p;                    // the first row to update, rows of `width` floats, dense
  const float* g;              // the gradient's element (0, 0, 0), read by its strides
  float* m;                    // the moments, dense as p
  float* v;
  long long g_row, g_mid, g_col;  // the gradient's strides in floats: row, middle, last
  int rows, width, inner;      // a row is [width / inner, inner]
  float lr;
};

namespace {

struct Group {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long g_row, g_mid, g_col;
  int n;        // floats: rows x width
  int width, inner, outer;
  int block0;   // the group's first block
  int vec;      // p, m and v 16-byte aligned
  float lr;
};

struct Table {
  Group grp[kMaxGroups];
  int n_groups;
};

struct Scalars {
  float b1, omb1, b2, omb2, ibc1, ibc2, eps;
};

__device__ __forceinline__ void adam_float(float& p, float& m, float& v, float g, float lr,
                                           const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.ibc2)), s.eps);
  p = __fsub_rn(p, __fmul_rn(lr, __fdiv_rn(__fmul_rn(m, s.ibc1), den)));
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const Table t, const Scalars s) {
  // the block's group: constant indices only, so the table is read from the parameter bank
  Group G = t.grp[0];
#pragma unroll
  for (int i = 1; i < kMaxGroups; ++i) {
    if (i < t.n_groups && static_cast<int>(blockIdx.x) >= t.grp[i].block0) G = t.grp[i];
  }
  float* __restrict__ P = G.p;
  const float* __restrict__ Gr = G.g;
  float* __restrict__ M = G.m;
  float* __restrict__ V = G.v;
  const int e0 = (static_cast<int>(blockIdx.x) - G.block0) * kBlockFloats +
                 static_cast<int>(threadIdx.x) * kVec;
  if (e0 >= G.n) return;
  // the gradient's address of float e0, then walk the row order
  int r = e0 / G.width;
  const int j = e0 - r * G.width;
  int a = j / G.inner;
  int b = j - a * G.inner;
  float gv[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    gv[q] = (e0 + q < G.n) ? Gr[r * G.g_row + a * G.g_mid + b * G.g_col] : 0.0f;
    if (++b == G.inner) {
      b = 0;
      if (++a == G.outer) {
        a = 0;
        ++r;
      }
    }
  }
  if (G.vec && e0 + kVec <= G.n) {
    float4 p4 = *reinterpret_cast<const float4*>(P + e0);
    float4 m4 = *reinterpret_cast<const float4*>(M + e0);
    float4 v4 = *reinterpret_cast<const float4*>(V + e0);
    adam_float(p4.x, m4.x, v4.x, gv[0], G.lr, s);
    adam_float(p4.y, m4.y, v4.y, gv[1], G.lr, s);
    adam_float(p4.z, m4.z, v4.z, gv[2], G.lr, s);
    adam_float(p4.w, m4.w, v4.w, gv[3], G.lr, s);
    *reinterpret_cast<float4*>(P + e0) = p4;
    *reinterpret_cast<float4*>(M + e0) = m4;
    *reinterpret_cast<float4*>(V + e0) = v4;
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int e = e0 + q;
      if (e < G.n) {
        float p = P[e], m = M[e], v = V[e];
        adam_float(p, m, v, gv[q], G.lr, s);
        P[e] = p;
        M[e] = m;
        V[e] = v;
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// groups: a host array of n_groups (1-8) descriptors, copied into the launch's parameters;
// b1, 1 - b1, b2, 1 - b2, 1 / bc1, 1 / bc2, eps as float32. Updates p, m and v in place.
SDPGS_API int sdpgs_fused_adam(const SdpgsAdamGroup* groups, int n_groups, float b1,
                               float omb1, float b2, float omb2, float ibc1, float ibc2,
                               float eps, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Table t = {};
  long long blocks = 0;
  for (int i = 0; i < n_groups; ++i) {
    const SdpgsAdamGroup& d = groups[i];
    const long long n = static_cast<long long>(d.rows) * d.width;
    if (d.rows < 0 || d.width < 1 || d.inner < 1 || d.width % d.inner != 0 ||
        n > INT_MAX - kBlockFloats) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Group& G = t.grp[i];
    G.p = d.p;
    G.g = d.g;
    G.m = d.m;
    G.v = d.v;
    G.g_row = d.g_row;
    G.g_mid = d.g_mid;
    G.g_col = d.g_col;
    G.n = static_cast<int>(n);
    G.width = d.width;
    G.inner = d.inner;
    G.outer = d.width / d.inner;
    G.block0 = static_cast<int>(blocks);
    G.vec = aligned16(d.p) && aligned16(d.m) && aligned16(d.v);
    G.lr = d.lr;
    blocks += (n + kBlockFloats - 1) / kBlockFloats;
  }
  t.n_groups = n_groups;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s = {b1, omb1, b2, omb2, ibc1, ibc2, eps};
  fused_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}
