// K7: stable sort of f32 keys carrying an int32 payload and the gid.
//
// Replaces sdpgs_tpu/ops/sort_pallas.py:_sort_kernel (pl.pallas_call at
// :178, reached through sort_by_key_pallas, :202): the counterpart of
// lax.sort((key, val1, gid), num_keys=1, is_stable=True) for gid = arange(N)
// and N a power of two in [2^14, 2^19]. The TPU kernel is a bitonic network
// on the (key, gid) order; with gid = arange(N) that order is the stable
// sort by key alone, so any stable sort gives it bit for bit.
//
// Bound on the H100: bytes. Three arrays read once and written once,
// 24 B x N (3.1 MB at N = 2^17): 0.94 us at 3.35 TB/s. Everything stays
// inside the 50 MB L2, so what sets the time is the number of launches and
// of dependent steps, not bandwidth. A bitonic network needs log N (log N
// + 1) / 2 compare-exchange steps (153 at 2^17), which on a GPU means a
// launch for every step too wide for one block (28 launches at 2^17).
//
// Design: a least-significant-digit radix sort, four passes of 8 bits
// over the key's order-preserving bits (sort_bits below, and its plain
// twin ops/sort.py:sort_bits): -0.0 folds into +0.0 (IEEE `==` makes them
// equal, so they keep gid order), then negatives have all bits flipped and
// non-negatives the sign bit set. Unsigned order of the bits is then IEEE
// `<`, +inf (dead slots) last; NaN is outside the domain, as in the TPU
// kernel. Keys move as their own bits, so -0.0 comes out as -0.0.
//
// One kernel reads the keys once and counts all four digit histograms.
// Each pass is then one kernel ("onesweep"): a block takes the next tile of
// kTile keys in input order (its tile index from an atomic counter, so a
// block only ever waits on blocks that already run), ranks each key among
// the keys of its digit stably (warps take contiguous runs; within a warp
// __match_any_sync groups equal digits and ranks in lane order, item by
// item), publishes its digit counts and finds the counts of all earlier
// tiles by a decoupled look-back over their published counts and
// prefixes, reorders the tile by digit in shared memory and writes keys,
// payload and gid together, coalesced. A key's place is the digit's global
// offset (from the histogram) + the earlier tiles' keys of that digit +
// its rank in the tile, so every pass is stable and the fourth leaves the
// keys in order. One memset, one histogram and four passes: 6 device
// operations, one read of the keys and 4 reads and 4 writes of the 12 B
// per key.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // keys per thread
constexpr int kTile = kThreads * kItems;      // keys per block: 2048
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;       // digits per pass
constexpr int kPasses = 32 / kRadixBits;
constexpr int kMaxN = 1 << 19;
constexpr unsigned kFullMask = 0xffffffffu;
// A tile's look-back word per digit: a flag in the top two bits, a count
// below. kAggregate: the tile's own count; kPrefix: the count of this
// and all earlier tiles.
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kPrefix = 2u << 30;
constexpr unsigned kCountMask = kAggregate - 1;

static_assert(kThreads == kRadix, "one thread per digit in the per-digit steps");

// Order-preserving bits of an f32 key (ops/sort.py:sort_bits is the plain twin).
__device__ __forceinline__ unsigned sort_bits(unsigned u) {
  if (u == 0x80000000u) u = 0u;  // -0.0 == +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned digit_of(unsigned key, int shift) {
  return (sort_bits(key) >> shift) & (kRadix - 1);
}

// Exclusive prefix sum of one value per thread, in thread order.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(kFullMask, inc, off);
    if (lane >= off) inc += up;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();  // s_warp is reused by the next scan
  return before + inc - v;
}

// hist [kPasses][kRadix], zeroed by the launcher: the digit counts of all
// n keys for every pass.
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const unsigned* __restrict__ key, unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[kPasses * kRadix];
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)blockIdx.x * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned b = sort_bits(key[base + j * kThreads + threadIdx.x]);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const unsigned d = (b >> (p * kRadixBits)) & (kRadix - 1);
      const unsigned peers = __match_any_sync(kFullMask, d);
      if (lane == __ffs(peers) - 1) {
        atomicAdd(&s_hist[p * kRadix + d], static_cast<unsigned>(__popc(peers)));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) {
    const unsigned c = s_hist[i];
    if (c != 0) atomicAdd(&hist[i], c);
  }
}

// One stable pass on the digit at `shift`: (kin, vin, gin) -> (kout, vout,
// gout). hist: this pass's [kRadix] counts; status [tiles][kRadix] and
// counter, zeroed by the launcher: the look-back words and the tile ticket.
__global__ void __launch_bounds__(kThreads)
pass_kernel(const unsigned* __restrict__ kin, const int* __restrict__ vin,
            const int* __restrict__ gin, unsigned* __restrict__ kout, int* __restrict__ vout,
            int* __restrict__ gout, const unsigned* __restrict__ hist, unsigned* status,
            unsigned* counter, int shift) {
  __shared__ unsigned s_key[kTile];
  __shared__ int s_val[kTile];
  __shared__ int s_gid[kTile];
  __shared__ unsigned s_warp_count[kWarps][kRadix];  // counts, then each warp's offsets
  __shared__ unsigned s_local[kRadix];               // the tile's exclusive digit prefix
  __shared__ unsigned s_out[kRadix];  // where s_key[s_local[d]] goes, less s_local[d]
  __shared__ unsigned s_scan[kWarps];
  __shared__ unsigned s_tile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp_count[w][threadIdx.x] = 0;
  __syncthreads();
  const unsigned tile = s_tile;

  // Warp w ranks keys [w * 32 * kItems, (w + 1) * 32 * kItems) of the tile,
  // item j of lane l at j * 32 + l: (j, l) order is input order.
  const size_t base = (size_t)tile * kTile + warp * 32 * kItems;
  unsigned k[kItems], d[kItems], rank[kItems];
  int v[kItems], g[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const size_t i = base + j * 32 + lane;
    k[j] = kin[i];
    v[j] = vin[i];
    g[j] = gin[i];
  }
  const unsigned lanes_before = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    d[j] = digit_of(k[j], shift);
    const unsigned peers = __match_any_sync(kFullMask, d[j]);
    const unsigned seen = s_warp_count[warp][d[j]];
    rank[j] = seen + __popc(peers & lanes_before);
    __syncwarp();
    if (lane == __ffs(peers) - 1) s_warp_count[warp][d[j]] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Thread dg owns digit dg: the warps' offsets and the tile's count.
  const unsigned dg = threadIdx.x;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp_count[w][dg];
    s_warp_count[w][dg] = count;
    count += c;
  }
  volatile unsigned* mine = status + (size_t)tile * kRadix + dg;
  *mine = (tile == 0 ? kPrefix : kAggregate) | count;
  const unsigned local = block_exclusive_scan(count, s_scan);
  const unsigned global = block_exclusive_scan(hist[dg], s_scan);
  unsigned earlier = 0;  // keys of digit dg in tiles before this one
  if (tile > 0) {
    for (unsigned p = tile - 1;; --p) {
      const volatile unsigned* theirs = status + (size_t)p * kRadix + dg;
      unsigned word;
      do {
        word = *theirs;
      } while ((word & ~kCountMask) == 0);
      earlier += word & kCountMask;
      if (word & kPrefix) break;  // tile 0 always publishes a prefix
    }
    *mine = kPrefix | (earlier + count);
  }
  s_local[dg] = local;
  s_out[dg] = global + earlier - local;
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned pos = s_local[d[j]] + s_warp_count[warp][d[j]] + rank[j];
    s_key[pos] = k[j];
    s_val[pos] = v[j];
    s_gid[pos] = g[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const unsigned key = s_key[i];
    const unsigned o = s_out[digit_of(key, shift)] + i;
    kout[o] = key;
    vout[o] = s_val[i];
    gout[o] = s_gid[i];
  }
}

int scratch_words(int n) { return kPasses * kRadix + kPasses + kPasses * (n / kTile) * kRadix; }

}  // namespace

#define SDPGS_LAUNCHED()                              \
  do {                                                \
    const cudaError_t err = cudaGetLastError();       \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// The int32 words of scratch sdpgs_sort_by_key needs for n keys.
SDPGS_API int sdpgs_sort_scratch_words(int n) { return scratch_words(n); }

// key, val, gid [n] (gid = arange(n)); key_out, val_out, gid_out [n],
// written whole; key_tmp, val_tmp, gid_tmp [n], the other side of the
// ping-pong; scratch [sdpgs_sort_scratch_words(n)] int32, zeroed here. n a
// multiple of 2048 and at most 2^19.
SDPGS_API int sdpgs_sort_by_key(const float* key, const int* val, const int* gid,
                                float* key_out, int* val_out, int* gid_out, float* key_tmp,
                                int* val_tmp, int* gid_tmp, int* scratch, int n,
                                void* stream) {
  if (n < kTile || n % kTile != 0 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = n / kTile;
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  unsigned* counters = hist + kPasses * kRadix;
  unsigned* status = counters + kPasses;
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(int) * static_cast<size_t>(scratch_words(n)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  histogram_kernel<<<tiles, kThreads, 0, s>>>(reinterpret_cast<const unsigned*>(key), hist);
  SDPGS_LAUNCHED();
  // in -> tmp -> out -> tmp -> out
  const unsigned* k_src = reinterpret_cast<const unsigned*>(key);
  const int* v_src = val;
  const int* g_src = gid;
  for (int p = 0; p < kPasses; ++p) {
    const bool to_tmp = (p % 2) == 0;
    unsigned* k_dst = reinterpret_cast<unsigned*>(to_tmp ? key_tmp : key_out);
    int* v_dst = to_tmp ? val_tmp : val_out;
    int* g_dst = to_tmp ? gid_tmp : gid_out;
    pass_kernel<<<tiles, kThreads, 0, s>>>(k_src, v_src, g_src, k_dst, v_dst, g_dst,
                                           hist + p * kRadix,
                                           status + static_cast<size_t>(p) * tiles * kRadix,
                                           counters + p, p * kRadixBits);
    SDPGS_LAUNCHED();
    k_src = k_dst;
    v_src = v_dst;
    g_src = g_dst;
  }
  return 0;
}
