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
// Bound on the H100: bytes, counted as the compulsory traffic (the packed
// rects and the sort order read once, the table and totals written once).
//
// Design: two launches and a scratch of coverage words, cover[t][w] (bit
// l of word w: sorted Gaussian 32 w + l's rect covers tile t), so a tile
// reads one word per 32 Gaussians instead of testing each rect in lock
// step with the whole block.
// (A) One warp per 32 consecutive sorted Gaussians and 32 tiles: for each
//     tile, one ballot of "my rect covers it" is the tile's word; lane j
//     keeps the word of tile t0 + j and stores it. Warps past the device
//     scalar n_valid leave at once (no host sync), and lanes past it cover
//     nothing, so every word below ceil(n_valid / 32) is written and no
//     other is read: the scratch needs no fill. T x ceil(n_valid / 32)
//     ballots in all.
// (B) One block per tile: each thread loads 4 consecutive words (16
//     bytes), a block-wide exclusive scan of their popcounts gives each set
//     bit its rank, in depth order, holes included; a set bit below K reads
//     its rect again for the slot d (four bits' loads in flight at once)
//     and writes order[p] at its rank where d < D, the sentinel P where
//     not. The block then writes P into slots [min(total, K), K) and the
//     uncapped total, so every slot of the table is written once and the
//     caller fills nothing.
// Ranks come from a deterministic scan, so the table is bit-identical to
// the plain version. The work grows as T x P / 32 words, not T x P rect
// tests, but the scratch, which the wrapper allocates on every call, grows
// as T x ceil(P / 128) x 16 bytes with the capacity P, not n_valid: 3 MB
// at P = 2^17 and 192 tiles (32-pixel tiles at 504x378), 49.5 MB at the
// same P with 8-pixel tiles (3,024 tiles), about 100 MB at P = 2^20 and
// 768 tiles. The old one-block-per-tile kernel needed none. Built for sm_90a: 24 registers (A) and 32 (B), no spill
// (nvcc -Xptxas -v).

#include "common.cuh"

namespace {

constexpr int kCoverThreads = 256;   // (A): 8 warps, 8 words of Gaussians
constexpr int kTableThreads = 512;   // (B)
constexpr int kWordsPerThread = 4;   // (B): one 16-byte load per thread per round
constexpr int kBitsInFlight = 4;     // (B): set bits whose loads a thread has in flight at once
constexpr unsigned kFullMask = 0xffffffffu;

// Words per tile row of the scratch: ceil(P / 32) rounded up to a whole
// 16-byte load, so every row starts 16-byte aligned.
int words_per_tile(int P) {
  return (P + 32 * kWordsPerThread - 1) / (32 * kWordsPerThread) * kWordsPerThread;
}

__global__ void __launch_bounds__(kCoverThreads)
cover_words_kernel(const int* __restrict__ packed_s, const int* __restrict__ n_valid_ptr,
                   unsigned* __restrict__ cover, int num_tiles, int tiles_x, int words) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n_valid = *n_valid_ptr;
  if (w * 32 >= n_valid) return;  // the whole warp
  const int p = w * 32 + lane;
  int xmin = 0, xmax = 0, ymin = 0, ymax = 0;  // an empty rect past n_valid
  if (p < n_valid) {
    const int pk = packed_s[p];
    xmin = pk & 0xFF;
    xmax = (pk >> 8) & 0xFF;
    ymin = (pk >> 16) & 0xFF;
    ymax = (pk >> 24) & 0xFF;
  }
  // this warp's 32 tiles (blockIdx.y); tiles past num_tiles lie below every rect
  const int t0 = blockIdx.y * 32;
  int tx = t0 % tiles_x, ty = t0 / tiles_x;
  unsigned mine = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const unsigned word =
        __ballot_sync(kFullMask, tx >= xmin && tx < xmax && ty >= ymin && ty < ymax);
    if (lane == j) mine = word;
    if (++tx == tiles_x) {
      tx = 0;
      ++ty;
    }
  }
  if (t0 + lane < num_tiles) cover[(size_t)(t0 + lane) * words + w] = mine;
}

// Takes the lowest set bit of `bits` (clearing it) as a Gaussian of word
// `word`; -1 where no bit is left.
__device__ __forceinline__ int take_bit(unsigned& bits, int word) {
  if (bits == 0) return -1;
  const int p = word * 32 + __ffs(bits) - 1;
  bits &= bits - 1;
  return p;
}

__global__ void __launch_bounds__(kTableThreads)
bin_table_kernel(const int* __restrict__ packed_s, const int* __restrict__ order,
                 const int* __restrict__ n_valid_ptr, const unsigned* __restrict__ cover,
                 int* __restrict__ table, int* __restrict__ totals, int P, int tiles_x,
                 int words, int K, int D) {
  __shared__ int warp_base[32];
  __shared__ int chunk_total;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int used = (*n_valid_ptr + 31) >> 5;  // the words (A) wrote
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned* src = cover + (size_t)tile * words;
  int* row = table + (size_t)tile * K;

  int base = 0;
  for (int w0 = 0; w0 < used; w0 += blockDim.x * kWordsPerThread) {
    const int wt = w0 + threadIdx.x * kWordsPerThread;
    unsigned wd[kWordsPerThread] = {0u, 0u, 0u, 0u};
    if (wt + kWordsPerThread <= used) {
      const uint4 q = *reinterpret_cast<const uint4*>(src + wt);
      wd[0] = q.x;
      wd[1] = q.y;
      wd[2] = q.z;
      wd[3] = q.w;
    } else {
      for (int k = 0; k < kWordsPerThread && wt + k < used; ++k) wd[k] = src[wt + k];
    }
    const int mine = __popc(wd[0]) + __popc(wd[1]) + __popc(wd[2]) + __popc(wd[3]);
    // block-wide exclusive scan of `mine`: within the warp, then the warps
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? warp_base[lane] : 0;
      int wincl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFullMask, wincl, o);
        if (lane >= o) wincl += up;
      }
      if (lane < nwarps) warp_base[lane] = wincl - v;
      if (lane == 31) chunk_total = wincl;
    }
    __syncthreads();
    // the set bits in order, four at a time so their loads are in flight together
    int rank = base + warp_base[warp] + incl - mine;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      unsigned bits = wd[k];
      while (bits != 0 && rank < K) {
        int p[kBitsInFlight], pk[kBitsInFlight], id[kBitsInFlight];
#pragma unroll
        for (int j = 0; j < kBitsInFlight; ++j) p[j] = take_bit(bits, wt + k);
#pragma unroll
        for (int j = 0; j < kBitsInFlight; ++j) {
          pk[j] = p[j] >= 0 ? packed_s[p[j]] : 0;
          id[j] = p[j] >= 0 ? order[p[j]] : 0;
        }
#pragma unroll
        for (int j = 0; j < kBitsInFlight; ++j) {
          if (p[j] >= 0 && rank < K) {
            const int xmin = pk[j] & 0xFF, xmax = (pk[j] >> 8) & 0xFF;
            const int ymin = (pk[j] >> 16) & 0xFF;
            const int d = (ty - ymin) * (xmax - xmin) + (tx - xmin);
            row[rank++] = d < D ? id[j] : P;
          }
        }
      }
    }
    base += chunk_total;
    __syncthreads();  // warp_base / chunk_total are rewritten next round
  }
  for (int i = min(base, K) + threadIdx.x; i < K; i += blockDim.x) row[i] = P;
  if (threadIdx.x == 0) totals[tile] = base;
}

}  // namespace

// Words of scratch `sdpgs_bin_table` takes for P sorted Gaussians, per tile.
SDPGS_API int sdpgs_bin_table_scratch_words(int P) { return words_per_tile(P); }

// packed_s, order: [P] i32 depth-sorted rects and Gaussian ids; n_valid: a
// device i32 (no host sync). table [num_tiles*K] i32 and totals
// [num_tiles] i32 (uncapped counts) are written whole; cover is scratch
// of num_tiles * sdpgs_bin_table_scratch_words(P) u32, in any state.
SDPGS_API int sdpgs_bin_table(const int* packed_s, const int* order, const int* n_valid,
                              int* table, int* totals, unsigned* cover, int P, int num_tiles,
                              int tiles_x, int K, int D, void* stream) {
  if (num_tiles == 0) return 0;
  const int words = words_per_tile(P);
  auto s = static_cast<cudaStream_t>(stream);
  const int warps_per_block = kCoverThreads / 32;
  const dim3 blocks((words + warps_per_block - 1) / warps_per_block, (num_tiles + 31) / 32);
  if (blocks.x > 0) {
    cover_words_kernel<<<blocks, kCoverThreads, 0, s>>>(packed_s, n_valid, cover, num_tiles,
                                                        tiles_x, words);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  bin_table_kernel<<<num_tiles, kTableThreads, 0, s>>>(packed_s, order, n_valid, cover, table,
                                                       totals, P, tiles_x, words, K, D);
  return static_cast<int>(cudaGetLastError());
}
