// K2: the per-tile binning table.
//
// Replaces sdpgs_tpu/ops/rasterize/rank_pallas.py:_rank_compact_lanes_kernel
// (the default; pl.pallas_call at :851, reached through
// compute_compact_entries_lanes_pallas from binning.py:186-204) and the two
// other TPU VMEM layouts of the same function, _rank_compact_kernel
// (pallas_call :485) and _rank_kernel (pallas_call :134). All three yield,
// after binning.py's scatter, one [T, K] table of Gaussian ids in depth
// order per tile (sentinel P), plus per-tile counts.
//
// Semantics (the scan path, binning.py:259-344): the rank of Gaussian p in
// tile t is the number of depth-earlier Gaussians whose tile RECT covers t,
// including those whose entry for t was cut by the D cap. p's entry for t
// is kept when its row-major rect slot d = (ty-ymin)*w + (tx-xmin) < D and
// its rank < K; the table therefore has sentinel holes where a covering
// Gaussian lost its entry to the D cap, and the counts include the holes.
//
// Bound on the H100: bytes at this size, counted as the compulsory traffic
// (the packed rects and the sort order read once, the table and totals
// written once). The kernel itself does T x n_valid rect tests: each block
// re-reads the sorted rects (0.5 MB at P = 131,072), which stay in the
// 50 MB L2, so the tests, not DRAM, set its time. That grows as T x P and
// wants a different design (per-Gaussian key duplication + sort, or tile
// bins) at 1M Gaussians x 768 tiles.
//
// Design: one block per tile walks the depth-sorted Gaussians up to
// n_valid (valid ones sort first) in chunks of blockDim. Each thread tests
// its Gaussian's rect; a block-wide exclusive scan of the 0/1 cover flags
// (warp ballot + popc, then a shuffle scan of the warp totals) plus a
// running base gives the rank, and a kept entry writes its Gaussian id to
// table[tile*K + rank]. Ranks come from a deterministic scan, so the table
// is bit-identical to the plain version.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bin_table_kernel(const int* __restrict__ packed_s, const int* __restrict__ order,
                 const int* __restrict__ n_valid_ptr, int* __restrict__ table,
                 int* __restrict__ totals, int tiles_x, int K, int D) {
  __shared__ int warp_base[32];
  __shared__ int chunk_total;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int n_valid = *n_valid_ptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* row = table + (size_t)tile * K;

  int base = 0;
  for (int start = 0; start < n_valid; start += blockDim.x) {
    const int p = start + threadIdx.x;
    bool covers = false;
    int d = 0;
    if (p < n_valid) {
      const int pk = packed_s[p];
      const int xmin = pk & 0xFF, xmax = (pk >> 8) & 0xFF;
      const int ymin = (pk >> 16) & 0xFF, ymax = (pk >> 24) & 0xFF;
      covers = tx >= xmin && tx < xmax && ty >= ymin && ty < ymax;
      d = (ty - ymin) * (xmax - xmin) + (tx - xmin);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, covers);
    const int within = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? warp_base[lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      if (lane < nwarps) warp_base[lane] = incl - v;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    const int rank = base + warp_base[warp] + within;
    if (covers && d < D && rank < K) row[rank] = order[p];
    base += chunk_total;
    __syncthreads();  // warp_base / chunk_total are rewritten next chunk
  }
  if (threadIdx.x == 0) totals[tile] = base;
}

}  // namespace

// packed_s, order: [P] i32 depth-sorted rects and Gaussian ids; n_valid: a
// device i32 (no host sync). table [num_tiles*K] i32 prefilled with the
// sentinel P by the caller; totals [num_tiles] i32 (uncapped counts).
SDPGS_API int sdpgs_bin_table(const int* packed_s, const int* order,
                              const int* n_valid, int* table, int* totals,
                              int num_tiles, int tiles_x, int K, int D,
                              void* stream) {
  if (num_tiles == 0) return 0;
  bin_table_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed_s, order, n_valid, table, totals, tiles_x, K, D);
  return static_cast<int>(cudaGetLastError());
}
