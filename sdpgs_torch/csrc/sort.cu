// K7: stable sort of f32 keys carrying an int32 payload and the gid.
//
// Replaces sdpgs_tpu/ops/sort_pallas.py:_sort_kernel (pl.pallas_call at
// :178, reached through sort_by_key_pallas, :202): the counterpart of
// lax.sort((key, val1, gid), num_keys=1, is_stable=True) for gid = arange(N)
// and N a power of two in [2^14, 2^19]. Like the TPU kernel it is a
// bitonic network on the composite (key, gid) order,
// (k_a < k_b) | (k_a == k_b & g_a < g_b) (sort_pallas.py:57-59): with
// distinct gids that order is strict, so the network's output is the one
// sorted sequence, which is the stable sort's, bit for bit. IEEE `<` and
// `==` treat -0.0 and +0.0 as equal (so they keep gid order, as lax.sort
// and torch.sort(stable=True) do) and put +inf (dead slots) last. NaN is
// outside the domain, as in the TPU kernel.
//
// The TPU kernel keeps all of N in VMEM as [R, 128] rows and swaps lanes
// and rows with transposes. None of that is carried over. Here a block of
// 1024 threads sorts a tile of kTile = 2048 elements in shared memory
// (24 KB for the three arrays) through stages 1..11; every later stage
// runs its partner distances >= kTile as global passes (one thread per
// pair) and the distances below kTile as one shared-memory merge per tile.
// At N = 2^17 that is 1 tile sort, 21 global passes and 6 merges.
//
// Bound on the H100: bytes. Three arrays read once and written once,
// 24 B x N (3.1 MB at N = 2^17): 0.94 us at 3.35 TB/s. The network moves
// them once per launch (28 launches at 2^17, all inside the 50 MB L2), so
// launch latency, not bandwidth, sets its time.

#include "common.cuh"

namespace {

constexpr int kTileThreads = 1024;
constexpr int kTile = 2 * kTileThreads;  // elements sorted in shared memory
constexpr int kLogTile = 11;
constexpr int kPassThreads = 256;

// true where (ka, ga) sorts strictly before (kb, gb)
__device__ __forceinline__ bool before(float ka, int ga, float kb, int gb) {
  return (ka < kb) || (ka == kb && ga < gb);
}

// The lower position of the pair that thread t handles at partner
// distance `stride` (a power of two): t's bits above log2(stride) move up
// one place.
__device__ __forceinline__ int pair_low(int t, int stride) {
  return ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
}

// Compare-exchange of positions i < l: ascending blocks keep the smaller
// (key, gid) at i, descending blocks the larger.
__device__ __forceinline__ void exchange(float* k, int* p, int* g, int i, int l, bool asc) {
  const float ki = k[i], kl = k[l];
  const int gi = g[i], gl = g[l];
  if (before(kl, gl, ki, gi) == asc) {
    k[i] = kl;
    k[l] = ki;
    g[i] = gl;
    g[l] = gi;
    const int pi = p[i];
    p[i] = p[l];
    p[l] = pi;
  }
}

// Passes at distances kTile/2 .. 1 of the stage of block size `size`
// (all of stages 1..11 when first_stage is 1), on one tile in shared
// memory, reading from (kin, pin, gin) and writing to (kout, pout, gout),
// which a merge passes as the same arrays (so no __restrict__ here).
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float* kin, const int* pin, const int* gin, float* kout, int* pout,
            int* gout, int first_stage, int last_stage) {
  __shared__ float k[kTile];
  __shared__ int p[kTile];
  __shared__ int g[kTile];
  const int base = blockIdx.x * kTile;
  for (int t = threadIdx.x; t < kTile; t += kTileThreads) {
    k[t] = kin[base + t];
    p[t] = pin[base + t];
    g[t] = gin[base + t];
  }
  __syncthreads();
  for (int s = first_stage; s <= last_stage; ++s) {
    const int size = 1 << s;
    for (int stride = min(size, kTile) >> 1; stride > 0; stride >>= 1) {
      const int i = pair_low(threadIdx.x, stride);
      exchange(k, p, g, i, i + stride, ((base + i) & size) == 0);
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < kTile; t += kTileThreads) {
    kout[base + t] = k[t];
    pout[base + t] = p[t];
    gout[base + t] = g[t];
  }
}

// One pass at a partner distance `stride` >= kTile, in place in global memory.
__global__ void __launch_bounds__(kPassThreads)
global_pass_kernel(float* __restrict__ k, int* __restrict__ p, int* __restrict__ g,
                   int size, int stride, int half_n) {
  const int t = blockIdx.x * kPassThreads + threadIdx.x;
  if (t >= half_n) return;
  const int i = pair_low(t, stride);
  exchange(k, p, g, i, i + stride, (i & size) == 0);
}

}  // namespace

#define SDPGS_LAUNCHED()                              \
  do {                                                \
    const cudaError_t err = cudaGetLastError();       \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// key, val, gid [n] (gid = arange(n)); key_out, val_out, gid_out [n],
// written whole; n a power of two, at least kTile.
SDPGS_API int sdpgs_sort_by_key(const float* key, const int* val, const int* gid,
                                float* key_out, int* val_out, int* gid_out, int n,
                                void* stream) {
  if (n < kTile || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_n = 31 - __builtin_clz(static_cast<unsigned>(n));
  const int tiles = n / kTile;
  tile_kernel<<<tiles, kTileThreads, 0, s>>>(key, val, gid, key_out, val_out, gid_out, 1,
                                             kLogTile);
  SDPGS_LAUNCHED();
  const int half_n = n / 2;
  const int pass_blocks = (half_n + kPassThreads - 1) / kPassThreads;
  for (int stage = kLogTile + 1; stage <= log_n; ++stage) {
    const int size = 1 << stage;
    for (int stride = size >> 1; stride >= kTile; stride >>= 1) {
      global_pass_kernel<<<pass_blocks, kPassThreads, 0, s>>>(key_out, val_out, gid_out, size,
                                                               stride, half_n);
      SDPGS_LAUNCHED();
    }
    tile_kernel<<<tiles, kTileThreads, 0, s>>>(key_out, val_out, gid_out, key_out, val_out,
                                               gid_out, stage, stage);
    SDPGS_LAUNCHED();
  }
  return 0;
}
