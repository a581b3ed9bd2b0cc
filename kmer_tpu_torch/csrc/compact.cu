// On-device compaction for Hopper (sm_90a): the live lanes (count > 0) of
// one count step's output, written contiguously as host-ready records,
// and how many there are.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/compact.py `pack_groups`
// (and the partition sort of kmer_tpu/ops/count.py `compact_from_runs`
// that feeds it).
//
// What bounds it: memory.  It reads one count a lane (int8 from the fused
// steps, int32 from the grouped counts of csrc/grouped_count.cu) and the
// key planes (8 or 16 bytes) of live lanes only, and writes one record (8
// or 16 bytes of key + an 8-byte count) a live lane.
//
// Design: the TPU kernel packs each group's record rows with one linear
// DMA and lets group g+1 overwrite group g's dead tail, which needs its
// grid to run in order.  Blocks on Hopper run in no order, so this is a
// two-launch stream compaction instead:
//   1. count: each block counts the live lanes of its TILE-lane tile;
//   2. scatter: each block sums the counts of the tiles before it (its
//      base), then walks its tile in rounds of THREADS consecutive
//      lanes: a warp ballot ranks each live lane in its warp, one
//      shared-memory pass over the warp totals ranks the warps, and the
//      live lanes of a round store to consecutive records.  The last
//      block writes the total.
// The output is therefore the stable compaction of the lane stream, and
// both the loads and the stores of a warp are contiguous.  In the count
// pass a thread owns ITEMS = 16 consecutive lanes, so its counts arrive
// in one 16-byte load.  Records are written in the layout the host
// aggregation takes (pipeline/table.reduce_fused): a k <= 31 key as it
// is; a pair (hi, lo) -- gapped, or a key of 32 to 63 bases -- as its
// value hi * 4^r_len + lo, one uint64 when it fits 63 bits, else the two
// uint64 halves [vhi, vlo]; at r_len = 32 (s = 64) those are hi and lo
// with its stored top-bit flip taken off.  Counts widen to int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

// live flags of the ITEMS lanes a thread owns, as a bit mask
template <typename C>
__device__ __forceinline__ uint32_t live_mask(const C* __restrict__ counts,
                                              int64_t first, int64_t n) {
  constexpr int PER_LOAD = 16 / sizeof(C);
  uint32_t m = 0;
  if (first + ITEMS <= n) {
#pragma unroll
    for (int v = 0; v < ITEMS / PER_LOAD; ++v) {
      const int4 x =
          __ldg(reinterpret_cast<const int4*>(counts + first) + v);
      const C* c = reinterpret_cast<const C*>(&x);
#pragma unroll
      for (int j = 0; j < PER_LOAD; ++j)
        m |= (uint32_t)(c[j] > 0) << (v * PER_LOAD + j);
    }
  } else {
    for (int j = 0; j < ITEMS && first + j < n; ++j)
      m |= (uint32_t)(__ldg(counts + first + j) > 0) << j;
  }
  return m;
}

// block-wide sum of v, returned to every thread
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int64_t s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <typename C>
__global__ void __launch_bounds__(THREADS)
compact_count_kernel(const C* __restrict__ counts, int64_t n,
                     int32_t* __restrict__ block_live) {
  __shared__ int64_t red[WARPS];
  const int64_t first = (int64_t)blockIdx.x * TILE + (int64_t)threadIdx.x * ITEMS;
  const int live = __popc(first < n ? live_mask(counts, first, n) : 0u);
  const int64_t s = block_sum(live, red);
  if (threadIdx.x == 0) block_live[blockIdx.x] = (int32_t)s;
}

// mode 0: one int64 key plane, written as it is;
// mode 1: gapped (hi, lo) written as the one-word value (hi << s) | lo;
// mode 2: gapped (hi, lo) written as [hi >> (64 - s), (hi << s) | lo],
//         or [hi, lo ^ 2^63] at s = 64
template <typename C>
__global__ void __launch_bounds__(THREADS)
compact_scatter_kernel(const int64_t* __restrict__ key0,
                       const int64_t* __restrict__ key1,
                       const C* __restrict__ counts, int64_t n,
                       const int32_t* __restrict__ block_live, int mode,
                       int s, int64_t* __restrict__ out_keys,
                       int64_t* __restrict__ out_counts,
                       int64_t* __restrict__ total) {
  __shared__ int64_t red[WARPS];
  __shared__ int warp_live[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // base: the live lanes of every tile before this one
  int64_t before = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += THREADS)
    before += block_live[i];
  int64_t o = block_sum(before, red);

  // ITEMS rounds of THREADS consecutive lanes: neighbouring threads load
  // neighbouring lanes, and the live ones of a round store to
  // neighbouring records
  const int64_t tile = (int64_t)blockIdx.x * TILE;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = tile + (int64_t)j * THREADS + threadIdx.x;
    const int c = i < n ? (int)__ldg(counts + i) : 0;
    const uint32_t ballot = __ballot_sync(0xffffffffu, c > 0);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int below = 0, round = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = warp_live[w];
      below += w < warp ? t : 0;
      round += t;
    }
    if (c > 0) {
      const int64_t r = o + below + __popc(ballot & ((1u << lane) - 1u));
      const int64_t k0 = __ldg(key0 + i);
      if (mode == 0) {
        out_keys[r] = k0;
      } else {
        const uint64_t hi = (uint64_t)k0, lo = (uint64_t)__ldg(key1 + i);
        if (s == 64) {
          out_keys[2 * r] = (int64_t)hi;
          out_keys[2 * r + 1] = (int64_t)(lo ^ (1ull << 63));
        } else if (mode == 1) {
          out_keys[r] = (int64_t)((hi << s) | lo);
        } else {
          out_keys[2 * r] = (int64_t)(hi >> (64 - s));
          out_keys[2 * r + 1] = (int64_t)((hi << s) | lo);
        }
      }
      out_counts[r] = c;
    }
    o += round;
    __syncthreads();                 // warp_live is rewritten next round
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *total = o;
}

template <typename C>
int compact_rows(const int64_t* key0, const int64_t* key1, const C* counts,
                 int64_t n, int32_t* block_live, int mode, int s,
                 int64_t* out_keys, int64_t* out_counts, int64_t* total,
                 cudaStream_t st) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  compact_count_kernel<C><<<(unsigned)tiles, THREADS, 0, st>>>(counts, n,
                                                               block_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scatter_kernel<C><<<(unsigned)tiles, THREADS, 0, st>>>(
      key0, key1, counts, n, block_live, mode, s, out_keys, out_counts, total);
  return (int)cudaGetLastError();
}

}  // namespace

// key0/key1: n int64 lanes each (key1 unused in mode 0); counts: n int8
// (count_bytes 1) or int32 (count_bytes 4), 16-byte aligned; block_live:
// ceil(n / 4096) int32 scratch; out_keys: n (modes 0, 1) or 2n (mode 2)
// int64; out_counts: n int64; total: one int64.  s = 2 * r_len in [2, 62]
// for mode 1, [2, 64] for mode 2.  Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int compact_launch(const int64_t* key0, const int64_t* key1,
                              const void* counts, int count_bytes, int64_t n,
                              int32_t* block_live, int mode, int s,
                              int64_t* out_keys, int64_t* out_counts,
                              int64_t* total, void* stream) {
  static_assert(TILE == 4096, "ops/kernels/compact.py sizes the scratch");
  const int64_t tiles = (n + TILE - 1) / TILE;
  if (n < 1 || tiles > 0x7FFFFFFF || mode < 0 || mode > 2 ||
      (count_bytes != 1 && count_bytes != 4) ||
      (mode != 0 && (s < 2 || s > (mode == 2 ? 64 : 62) || key1 == nullptr)) ||
      (reinterpret_cast<uintptr_t>(counts) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 1)
    return compact_rows<int8_t>(key0, key1,
                                static_cast<const int8_t*>(counts), n,
                                block_live, mode, s, out_keys, out_counts,
                                total, st);
  return compact_rows<int32_t>(key0, key1,
                               static_cast<const int32_t*>(counts), n,
                               block_live, mode, s, out_keys, out_counts,
                               total, st);
}
