// K8: the launch-floor probe, out = packed + gid + tid[:, 0].
//
// Replaces scripts/perf_rank_variants.py:_overhead_kernel (pl.pallas_call
// in make_overhead_call, :58): row C of that script, a near-empty kernel
// over the rank kernel's grid (P/256 blocks of 256 slots) that reads the
// same inputs as the binning kernel and does one add per slot. Its time is
// the floor under the port's kernel times: what any launch over this grid
// costs before it does work.
//
// Bound on the H100: bytes. Per slot packed, gid and out (4 B each) and
// the 32 B sector of tid's row that holds tid[i, 0]: 44 B x P, 5.8 MB at
// P = 131,072, 1.7 us at 3.35 TB/s.
//
// Design: one thread per slot on the same P/256 x 256 grid; the adds wrap
// as int32 adds do (unsigned arithmetic, no signed overflow).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
launch_floor_kernel(const int* __restrict__ packed, const int* __restrict__ gid,
                    const int* __restrict__ tid, int* __restrict__ out, int P, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const unsigned sum = static_cast<unsigned>(packed[i]) + static_cast<unsigned>(gid[i]) +
                       static_cast<unsigned>(tid[static_cast<size_t>(i) * D]);
  out[i] = static_cast<int>(sum);
}

}  // namespace

// packed, gid [P] i32; tid [P, D] i32; out [P] i32, written whole.
SDPGS_API int sdpgs_launch_floor(const int* packed, const int* gid, const int* tid, int* out,
                                 int P, int D, void* stream) {
  if (P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_floor_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(packed, gid, tid, out,
                                                                          P, D);
  return static_cast<int>(cudaGetLastError());
}
