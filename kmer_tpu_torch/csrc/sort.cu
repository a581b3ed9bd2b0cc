// Stable multi-word sort of W int64 word planes (1 <= W <= MAX_PLANES) for
// Hopper (sm_90a), in place: the rows (w0[i], ..., w{W-1}[i]) ordered by their
// first K words (the keys), compared as signed int64 with word 0 most
// significant; the other W - K words ride along as payload, and rows with
// equal keys keep their input order.  The all-INT64_MAX sentinel row
// sorts last.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/sort.py `sort_words_pallas`
// (`_chunk_sort_kernel`, `_chunk_merge_kernel` and the cross-chunk stage
// `_cross_chunk_stage` between them), which sorts every word as a key.
//
// What bounds it: memory.  The least work is one read and one write of
// every word; a least-significant-digit (LSD) radix sort makes one pass
// over the rows a digit, each reading the key word twice and every word
// once and writing every word once.  So the design trims digits: key word
// q carries a promise bits[q] that its values lie in [0, 2^bits) or are
// the sentinel, and its digit code is
//   bits < 64:  v == INT64_MAX ? 2^bits : v   (bits + 1 significant bits:
//               the sentinel sorts last without widening the range)
//   bits == 64: v ^ 2^63                      (signed order as unsigned)
// cut into 8-bit digits, ceil(significant bits / 8) passes a key word; a
// 42-bit key word (k = 21) takes six passes.
//
// One pass, three kernels:
//   1. hist_kernel: a TILE-row tile's digit counts in shared memory (a
//      histogram a warp, so that only a warp's lanes contend), written
//      digit-major, counts[d * tiles + t];
//   2. scan_kernel: one block a digit scans its row of counts over the
//      tiles (exclusive, in place) and writes the digit's total;
//   3. scatter_kernel: a tile recomputes its digits and ranks its rows
//      stably -- each warp walks its rows in row order, __match_any_sync
//      groups the lanes of one digit and a per-warp counter in shared
//      memory carries the rank from one step to the next; the warps'
//      counters are then scanned in warp order -- stages every word in
//      shared memory in digit order, and writes it out, so that
//      neighbouring threads write neighbouring addresses of a digit's run.
// A thread owns ITEMS rows of its warp's stripe (row = warp's base + i *
// 32 + lane), so (item, lane) order is row order.  Rows past n in the last
// tile take the largest digit: they rank after every real row of the tile
// and are never written.  The passes ping-pong between the caller's planes
// and a scratch block the caller allocates; after an odd number of passes
// the rows are copied back once.  The pass count follows from K and the
// bits alone, so the host never waits on the device.  Row indices are
// 64-bit throughout.

// The planes travel by value, as a struct of MAX_PLANES pointers (a
// kernel's parameters hold 4 KB, and the scatter kernel takes two sets), so
// key and payload words can be any count up to it: the k = 101 device
// merge sorts 4 key words with the counts as payload, 5 planes.  The
// scatter kernel is unrolled for W <= 4 and loops over the planes beyond.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;              // a tile's block
constexpr int ITEMS = 16;                 // rows a thread
constexpr int TILE = THREADS * ITEMS;     // 4096 rows
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;                 // 8-bit digits
constexpr int LANE_BINS = BINS / 32;      // a lane's bins in a warp's scan
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

// the planes, by value: a kernel's parameters hold 4 KB, and the scatter
// kernel takes two sets of pointers
constexpr int MAX_PLANES = 240;
struct Planes {
  int64_t* w[MAX_PLANES];
};

// digit `shift / 8` of a key word's code (see the note at the top)
struct Digit {
  int bits;
  int shift;
  __device__ __forceinline__ unsigned of(int64_t v) const {
    const uint64_t code =
        bits < 64 ? (v == INT64_MAX ? 1ull << bits : (uint64_t)v)
                  : (uint64_t)v ^ (1ull << 63);
    return (unsigned)(code >> shift) & (BINS - 1);
  }
};

// shared memory of scatter_kernel
constexpr size_t SCATTER_SMEM =
    TILE * sizeof(int64_t)                 // s_buf: one word of the tile
    + BINS * sizeof(int64_t)               // s_off: a digit's rows less slots
    + WARPS * BINS * sizeof(unsigned)      // s_whist: per-warp digit counts
    + BINS * sizeof(unsigned)              // s_lbase: a digit's tile start
    + TILE;                                // s_digit: the digit at a slot

__global__ void __launch_bounds__(THREADS)
hist_kernel(const int64_t* __restrict__ key, int64_t n, int64_t tiles,
            Digit dg, int64_t* __restrict__ counts) {
  __shared__ unsigned s_hist[WARPS * BINS];        // a histogram a warp
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) s_hist[i] = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base =
      (int64_t)blockIdx.x * TILE + warp * (ITEMS * 32) + lane;
  int64_t v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t r = base + i * 32;
    v[i] = r < n ? key[r] : 0;
  }
  __syncthreads();
  unsigned* wh = s_hist + warp * BINS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (base + i * 32 < n) atomicAdd(&wh[dg.of(v[i])], 1u);
  __syncthreads();
  for (int d = threadIdx.x; d < BINS; d += THREADS) {
    unsigned sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += s_hist[w * BINS + d];
    counts[(int64_t)d * tiles + blockIdx.x] = sum;
  }
}

// inclusive scan over a warp's lanes
template <typename T>
__device__ __forceinline__ T warp_scan(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int64_t* __restrict__ counts, int64_t tiles,
            int64_t* __restrict__ totals) {
  __shared__ int64_t s_warp[SCAN_THREADS / 32];
  int64_t* row = counts + (int64_t)blockIdx.x * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t carry = 0;
  for (int64_t start = 0; start < tiles; start += SCAN_THREADS) {
    const int64_t t = start + threadIdx.x;
    const int64_t x = t < tiles ? row[t] : 0;
    const int64_t s = warp_scan(x, lane);
    if (lane == 31) s_warp[warp] = s;
    __syncthreads();
    if (warp == 0) s_warp[lane] = warp_scan(s_warp[lane], lane);
    __syncthreads();
    if (t < tiles) row[t] = carry + (warp ? s_warp[warp - 1] : 0) + s - x;
    carry += s_warp[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// one word of the tile, staged in s_buf in digit order, to its rows: slot
// p of digit d goes to row s_off[d] + p
__device__ __forceinline__ void write_out(const int64_t* s_buf,
                                          const int64_t* s_off,
                                          const unsigned char* s_digit,
                                          int tile_n, int64_t* out) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = j * THREADS + threadIdx.x;
    if (p < tile_n) out[s_off[s_digit[p]] + p] = s_buf[p];
  }
}

// W > 0: W planes, their loops unrolled; W == 0: nw planes
template <int W>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int64_t* __restrict__ key, Planes src, Planes dst,
               int nw, int64_t n, int64_t tiles, int q_key, Digit dg,
               const int64_t* __restrict__ counts,
               const int64_t* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_buf = reinterpret_cast<int64_t*>(smem);
  int64_t* s_off = s_buf + TILE;
  unsigned* s_whist = reinterpret_cast<unsigned*>(s_off + BINS);
  unsigned* s_lbase = s_whist + WARPS * BINS;
  unsigned char* s_digit = reinterpret_cast<unsigned char*>(s_lbase + BINS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * TILE;
  const int tile_n = (int)(n - tile0 < TILE ? n - tile0 : TILE);
  const int row0 = warp * (ITEMS * 32) + lane;     // item 0's row in the tile

  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) s_whist[i] = 0;
  int64_t v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = row0 + i * 32;
    v[i] = r < tile_n ? key[tile0 + r] : 0;
  }
  __syncthreads();

  // rank within the warp, in row order: digit << 16 | rank
  unsigned* wh = s_whist + warp * BINS;
  const unsigned below_mask = (1u << lane) - 1u;
  unsigned dr[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned d = row0 + i * 32 < tile_n ? dg.of(v[i]) : BINS - 1;
    const unsigned peers = __match_any_sync(FULL, d);
    const unsigned below = __popc(peers & below_mask);
    const unsigned c = wh[d];
    __syncwarp();
    if (below == 0) wh[d] = c + __popc(peers);
    __syncwarp();
    dr[i] = d << 16 | (c + below);
  }
  __syncthreads();

  // each digit: the warps' counts scanned in warp order; the tile's count
  for (int d = threadIdx.x; d < BINS; d += THREADS) {
    unsigned sum = 0;
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = s_whist[w * BINS + d];
      s_whist[w * BINS + d] = sum;
      sum += c;
    }
    s_lbase[d] = sum;
  }
  __syncthreads();
  // warp 0: the digits' starts in the tile; warp 1: their first rows in
  // the output (the digit's start over all tiles plus this tile's offset),
  // less the tile start below
  if (warp == 0) {
    unsigned c[LANE_BINS], sum = 0;
#pragma unroll
    for (int j = 0; j < LANE_BINS; ++j) {
      c[j] = s_lbase[lane * LANE_BINS + j];
      sum += c[j];
    }
    unsigned ex = warp_scan(sum, lane) - sum;
#pragma unroll
    for (int j = 0; j < LANE_BINS; ++j) {
      s_lbase[lane * LANE_BINS + j] = ex;
      ex += c[j];
    }
  } else if (warp == 1) {
    int64_t c[LANE_BINS], sum = 0;
#pragma unroll
    for (int j = 0; j < LANE_BINS; ++j) {
      c[j] = totals[lane * LANE_BINS + j];
      sum += c[j];
    }
    int64_t ex = warp_scan(sum, lane) - sum;
#pragma unroll
    for (int j = 0; j < LANE_BINS; ++j) {
      const int d = lane * LANE_BINS + j;
      s_off[d] = ex + counts[(int64_t)d * tiles + blockIdx.x];
      ex += c[j];
    }
  }
  __syncthreads();

  // each row's slot in digit order; the key word staged there
  int pos[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned d = dr[i] >> 16;
    pos[i] = s_lbase[d] + s_whist[warp * BINS + d] + (dr[i] & 0xFFFFu);
    s_digit[pos[i]] = (unsigned char)d;
    s_buf[pos[i]] = v[i];
  }
  for (int d = threadIdx.x; d < BINS; d += THREADS) s_off[d] -= s_lbase[d];
  __syncthreads();
  // the key word from s_buf; then each other word loaded, staged and
  // written the same way
  const int NW = W > 0 ? W : nw;
#pragma unroll
  for (int q = 0; q < NW; ++q)
    if (q == q_key) write_out(s_buf, s_off, s_digit, tile_n, dst.w[q]);
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    if (q == q_key) continue;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = row0 + i * 32;
      v[i] = r < tile_n ? src.w[q][tile0 + r] : 0;
    }
    __syncthreads();                      // s_buf's last word is out
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) s_buf[pos[i]] = v[i];
    __syncthreads();
    write_out(s_buf, s_off, s_digit, tile_n, dst.w[q]);
  }
}

template <int NW>
int sort_rows(const Planes& a, int W, int64_t* scratch, int64_t n, int K,
              const int* bits, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SCATTER_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + TILE - 1) / TILE;
  Planes b = {};
  for (int q = 0; q < W; ++q) b.w[q] = scratch + q * n;
  int64_t* counts = scratch + W * n;
  int64_t* totals = counts + BINS * tiles;
  const Planes* src = &a;
  const Planes* dst = &b;
  int passes = 0;
  for (int q = K - 1; q >= 0; --q) {
    const int sig = bits[q] < 64 ? bits[q] + 1 : 64;
    for (int shift = 0; shift < sig; shift += 8) {
      const Digit dg = {bits[q], shift};
      hist_kernel<<<(unsigned)tiles, THREADS, 0, st>>>(src->w[q], n, tiles,
                                                       dg, counts);
      scan_kernel<<<BINS, SCAN_THREADS, 0, st>>>(counts, tiles, totals);
      scatter_kernel<NW><<<(unsigned)tiles, THREADS, SCATTER_SMEM, st>>>(
          src->w[q], *src, *dst, W, n, tiles, q, dg, counts, totals);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const Planes* t = src;
      src = dst;
      dst = t;
      ++passes;
    }
  }
  if (passes & 1) {
    for (int q = 0; q < W; ++q) {
      err = cudaMemcpyAsync(a.w[q], b.w[q], n * sizeof(int64_t),
                            cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

// int64 words of the scratch block sort_words_launch needs for W planes of
// n rows: W * n for the second set of planes, then the digit counts.
extern "C" int64_t sort_scratch_words(int W, int64_t n) {
  return W * n + BINS * ((n + TILE - 1) / TILE) + BINS;
}

extern "C" int sort_tile_rows() { return TILE; }

extern "C" int sort_max_planes() { return MAX_PLANES; }

// planes: W host pointers to n int64 rows each, sorted in place on
// `stream` by their first K words; bits: the K key words' value bits
// (0..64).  scratch: sort_scratch_words(W, n) int64 words on the device.
// 1 <= K <= W <= MAX_PLANES, 1 <= n < 2^62.  Returns the first failing
// call's cudaError_t, or 0; never synchronises.
extern "C" int sort_words_launch(int64_t* const* planes, int W, int K,
                                 const int* bits, int64_t n,
                                 int64_t* scratch, void* stream) {
  if (W < 1 || W > MAX_PLANES || K < 1 || K > W || n < 1 ||
      n > ((int64_t)1 << 62) || (n + TILE - 1) / TILE > 0x7FFFFFFF ||
      scratch == nullptr || planes == nullptr || bits == nullptr)
    return (int)cudaErrorInvalidValue;
  Planes pl = {};
  for (int q = 0; q < W; ++q) {
    if (planes[q] == nullptr) return (int)cudaErrorInvalidValue;
    pl.w[q] = planes[q];
  }
  for (int q = 0; q < K; ++q)
    if (bits[q] < 0 || bits[q] > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return sort_rows<1>(pl, W, scratch, n, K, bits, st);
    case 2: return sort_rows<2>(pl, W, scratch, n, K, bits, st);
    case 3: return sort_rows<3>(pl, W, scratch, n, K, bits, st);
    case 4: return sort_rows<4>(pl, W, scratch, n, K, bits, st);
    default: return sort_rows<0>(pl, W, scratch, n, K, bits, st);
  }
}
