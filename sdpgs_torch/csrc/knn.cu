// k nearest neighbours by brute force: for each slot, the k nearest other valid slots, in one
// launch, with each slot's k best kept in registers.
//
// Replaces no Pallas kernel: the JAX package leaves the k-NN to XLA's matrix product and
// lax.top_k (sdpgs_tpu/ops/knn.py). The port ran it as PyTorch's chain (ops/knn.py:knn_plain):
// per chunk of 1,024 query rows a [1024, N] f32 distance block from one cuBLAS product, an
// int64 key block (the distance's ordered bits above the index) and a radix top-k over the
// keys, 128 chunks at 131,072 slots.
//
// Bound on the H100: f32 instructions. Each (query, candidate) pair costs a multiply and two
// fused multiply-adds for q.p, a fused multiply-add for |q|^2 - 2 q.p and an addition for the
// distance, and a compare against the row's current k-th best: 6 instructions. At 131,072
// slots of which 60,000 valid that is 4.7e10 instructions, 1.41 ms at 33.5 T f32
// instructions/s (67 TFLOP/s counting an FMA as two).
//
// What it computes, bit for bit as the plain version on the card:
// - The distance as the plain version's product and sums round it: t = qx px, fma(qy, py, t),
//   fma(qz, pz, t) (a K = 3 f32 matrix product's accumulation), d = (|q|^2 - 2 t) + |p|^2,
//   each step rounded once (the _rn intrinsics, and the file is built with -fmad=false); 2 t
//   is exact short of overflow, so fma(-2, t, |q|^2) rounds as |q|^2 - 2 t does. The
//   norms come from the caller, formed as the plain version forms them. The self slot and
//   invalid slots get +inf.
// - The selection in the plain version's int64 key order: the distance's ordered bits (-0.0
//   folded into +0.0; inf and NaN included) above the index. The k smallest keys, ascending.
//   A row with fewer than k valid neighbours lists the lowest-index dropped slots at +inf, as
//   a top-k over the keys does.
//
// Design:
// - A thread owns kQueries query rows and walks every candidate in ascending index, the
//   block's candidates staged kTile at a time through shared memory as (x, y, z, |p|^2), an
//   invalid slot's norm staged as +inf so its distance is +inf. Each staged candidate feeds
//   kQueries rows of the thread from one broadcast load.
// - Each row's list is k int64 keys in registers, sorted, started from the sentinel (the
//   largest key, the largest index). The hot loop tests a distance against the list's last
//   key as a float: !(d >= worst) passes every pair whose key can enter (a NaN worst, the
//   sentinel's or a NaN distance's, passes all). Only then is the exact key formed, the self
//   and invalid slots set to +inf, and the key carried through the list by integer
//   min / max. Candidates arrive in ascending index, so a strict compare gives ties to the
//   lower index, as the key order does.
// - No [chunk, N] block of any type: memory is the [N, k] outputs.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxK = 8;                         // the largest k a launch takes
constexpr int kThreads = 128;
constexpr int kQueries = 2;                      // query rows a thread
constexpr int kBlockRows = kThreads * kQueries;  // 256
constexpr int kTile = 512;                       // candidates staged a round
constexpr int kUnroll = 4;                       // candidates a step of the hot loop
constexpr int kMaxPoints = 1 << 30;
constexpr long long kSentinel = LLONG_MAX;       // ordered bits 0x7FFFFFFF, index 0xFFFFFFFF

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// The plain version's _ordered_bits: int32 bits that order like the f32 values.
__device__ __forceinline__ int ordered_bits(float d) {
  const int b = __float_as_int(__fadd_rn(d, 0.0f));
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

__device__ __forceinline__ float from_ordered(int b) {
  return __int_as_float(b < 0 ? (b ^ 0x7FFFFFFF) : b);
}

__device__ __forceinline__ long long make_key(int bits, int j) {
  return static_cast<long long>((static_cast<unsigned long long>(static_cast<unsigned>(bits))
                                 << 32) | static_cast<unsigned>(j));
}

__device__ __forceinline__ int key_bits(long long key) { return static_cast<int>(key >> 32); }

__device__ __forceinline__ float distance(float qx, float qy, float qz, float qn,
                                          const float4& c) {
  float t = __fmul_rn(qx, c.x);
  t = __fmaf_rn(qy, c.y, t);
  t = __fmaf_rn(qz, c.z, t);
  return __fadd_rn(__fmaf_rn(-2.0f, t, qn), c.w);
}

// Carry key through the sorted list: each slot keeps the smaller, the larger moves on, and
// the largest of the k + 1 drops off the end.
template <int K>
__device__ __forceinline__ void insert(long long (&list)[K], long long key) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const long long lo = key < list[s] ? key : list[s];
    key = key < list[s] ? list[s] : key;
    list[s] = lo;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ pts, const float* __restrict__ norm,
           const unsigned char* __restrict__ invalid, int n, float* __restrict__ out_d,
           long long* __restrict__ out_i) {
  __shared__ float4 cand[kTile];
  __shared__ unsigned char bad[kTile];

  int row[kQueries];
  float qx[kQueries], qy[kQueries], qz[kQueries], qn[kQueries], worst[kQueries];
  long long list[kQueries][K];
#pragma unroll
  for (int i = 0; i < kQueries; ++i) {
    row[i] = static_cast<int>(blockIdx.x) * kBlockRows + i * kThreads +
             static_cast<int>(threadIdx.x);
    // a row past the end computes row n - 1's list and writes nothing
    const long long r = row[i] < n ? row[i] : n - 1;
    qx[i] = pts[3 * r];
    qy[i] = pts[3 * r + 1];
    qz[i] = pts[3 * r + 2];
    qn[i] = norm[r];
#pragma unroll
    for (int s = 0; s < K; ++s) list[i][s] = kSentinel;
    worst[i] = from_ordered(key_bits(kSentinel));
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();
    for (int s = static_cast<int>(threadIdx.x); s < kTile; s += kThreads) {
      const int j = t0 + s;
      float4 c = make_float4(0.0f, 0.0f, 0.0f, f32_inf());
      unsigned char b = 1;
      if (j < n) {
        const long long jj = j;
        b = invalid != nullptr && invalid[j] != 0;
        c.x = pts[3 * jj];
        c.y = pts[3 * jj + 1];
        c.z = pts[3 * jj + 2];
        c.w = b ? f32_inf() : norm[j];
      }
      cand[s] = c;
      bad[s] = b;
    }
    __syncthreads();
    for (int s = 0; s < kTile; s += kUnroll) {
      float d[kUnroll][kQueries];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 c = cand[s + u];
#pragma unroll
        for (int i = 0; i < kQueries; ++i) {
          d[u][i] = distance(qx[i], qy[i], qz[i], qn[i], c);
          any |= !(d[u][i] >= worst[i]);
        }
      }
      if (!any) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = t0 + s + u;
#pragma unroll
        for (int i = 0; i < kQueries; ++i) {
          if (!(d[u][i] >= worst[i]) && j < n) {
            const float dd = (j == row[i] || bad[s + u]) ? f32_inf() : d[u][i];
            insert<K>(list[i], make_key(ordered_bits(dd), j));
            worst[i] = from_ordered(key_bits(list[i][K - 1]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQueries; ++i) {
    if (row[i] >= n) continue;
    const long long o = static_cast<long long>(row[i]) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float v = from_ordered(key_bits(list[i][s]));
      out_d[o + s] = v < 0.0f ? 0.0f : v;  // clamped at 0; NaN stays NaN
      out_i[o + s] = static_cast<long long>(static_cast<unsigned>(list[i][s] & 0xFFFFFFFFLL));
    }
  }
}

template <int K>
cudaError_t launch_k(const float* pts, const float* norm, const unsigned char* invalid, int n,
                     float* out_d, long long* out_i, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kBlockRows - 1) / kBlockRows);
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(pts, norm, invalid, n, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

// pts [n, 3] f32, norm [n] f32 (|p|^2 as the caller forms it), invalid [n] bytes (non-zero:
// never a neighbour) or null; writes out_d [n, k] f32 (squared distances, ascending, clamped
// at 0) and out_i [n, k] int64. 1 <= k <= kMaxK, k <= n.
SDPGS_API int sdpgs_knn(const float* pts, const float* norm, const unsigned char* invalid,
                        int n, int k, float* out_d, long long* out_i, void* stream) {
  if (n < 1 || n > kMaxPoints || k < 1 || k > kMaxK || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
    case 1: err = launch_k<1>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 2: err = launch_k<2>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 3: err = launch_k<3>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 4: err = launch_k<4>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 5: err = launch_k<5>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 6: err = launch_k<6>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 7: err = launch_k<7>(pts, norm, invalid, n, out_d, out_i, s); break;
    case 8: err = launch_k<8>(pts, norm, invalid, n, out_d, out_i, s); break;
    default: break;
  }
  return static_cast<int>(err);
}
