// Grouped run lengths and grouped sort + run lengths for Hopper (sm_90a),
// over W in {1, 2, 3, 4} int64 word planes (a row is (w0[e], ..., w{W-1}[e]),
// compared lexicographically as signed int64, word 0 most significant; a
// row whose word 0 is SENTINEL = INT64_MAX is a dead lane).
//
// Three entry points, each replacing a TPU kernel of
// kmer_tpu/ops/pallas/fused_count.py:
//   run_lengths_grouped_launch (K2a) <- `_scan_kernel`
//       (run_lengths_grouped_pallas): counts of group-sorted rows;
//   grouped_sort_count_launch with strides (1, m) (K2b) <- `_kernel`
//       (fused_grouped_count): sort each contiguous group, then counts;
//   grouped_sort_count_launch with strides (G, 1) (K2c) <- `_kernel` with
//       axis 0 (fused_grouped_count_sublane): the same over groups that are
//       strided columns, element i of group g at i * G + g.
// The count contract of all three: a run of equal rows inside a group has
// its length at its first row, every other row 0, and a dead run 0.
//
// What bounds them: memory for K2a (one read of each row, one int32 write);
// for K2b/K2c the
// sorting network's m log2(m)^2 / 4 compare-exchanges of W words each run
// in shared memory, so device memory sees each row once in and once out.
//
// Design.
// K2a: the TPU kernel takes a (64, m) block of groups into VMEM, marks run
// starts by comparing each lane with its rolled neighbour and takes the
// next start by a log2(m)-step suffix-min.  Here the block has no group
// shape: it is a flat scan over one flag a row (flag_scan.cuh).  Row i of
// the flat stream starts a run when i % m == 0 or it differs from row i - 1
// in any word; every group's first row is then a start, so the next start
// after i never lies past i's group end, and
//   count[i] = start[i] && word0[i] != SENTINEL ? next_start(i) - i : 0,
// next_start of the last row being n, for any m with no walk of a group.
// A thread owns RL_ROWS consecutive rows, loaded as 16-byte vectors of each
// plane (scalar loads when a plane is not 16-byte aligned); the row before
// its first comes from the lane before by a shuffle, and a warp's first
// row loads it.  The next start is found in the thread's own flag bits,
// then across the warp (a ballot), then across the block's warps (the
// least of the later warps' firsts in shared memory, behind the one
// barrier), then past the tile's end: the block's last warp tests the 32
// rows after the tile's end before the barrier, and only when none of them
// starts a run does the whole block scan on, RL_TILE rows a step, to the
// first start, which is at most one group away (m / RL_TILE + 1 steps).
// At the callers' default m = 256 a tile's end is a group's end, so the
// first test finds the start; a run of r rows makes each of the
// r / RL_TILE tiles it crosses scan to its end, r^2 / (2 RL_TILE) row
// reads in all (a user's sort_group_keys of 2^20 with one run filling a
// group would read 2^29 rows of the L2).  Counts are stored as 16-byte
// int32 vectors.  Blocks of 128 threads and 4 rows a thread: 256 or 512
// threads, 2 or 8 rows and registers capped for more blocks an SM measured
// slower (PERF.md §6).
// K2b/K2c: the TPU kernel runs a bitonic network along the lane (K2b) or
// sublane (K2c) axis of a VMEM block with rolls, comparing word 0 only.
// Here a block loads gpb whole groups (gpb * m >= MIN_ROWS rows, all W
// planes) into dynamic shared memory, sorts each by ALL W words with the
// all-ascending bitonic network of csrc/sort.cu (the first stage of a
// level pairs a row with its mirror), and so gives fully sorted groups
// that equal a stable sort's.  Run lengths then need no scan: a run start
// finds the end of its run by a binary search for the first greater row
// in its group.  The load and store walk the groups in the order in which
// neighbouring threads touch neighbouring addresses: element-major for
// strided columns (K2c), group-major for contiguous groups (K2b).  Over
// 48 KB of shared memory the launch needs cudaFuncSetAttribute first.

#include <cstdint>
#include <cuda_runtime.h>

#include "flag_scan.cuh"

namespace {

constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;
constexpr int RL_THREADS = 128;              // K2a: threads a block
constexpr int RL_ROWS = 4;                     // K2a: rows a thread
static_assert(RL_ROWS == 2 || RL_ROWS % 4 == 0, "K2a stores 8 or 16 bytes");
constexpr int RL_TILE = RL_THREADS * RL_ROWS;
constexpr int RL_WARPS = RL_THREADS / 32;
constexpr int SORT_THREADS = 512;
constexpr int MIN_ROWS = 2048;                 // rows a sort block takes at least
constexpr int SMEM_MAX = 232448;               // 227 KB: a block's shared memory

struct Planes {
  const int64_t* w[4];
};
struct OutPlanes {
  int64_t* w[4];
};

// The rows [first, first + RL_ROWS) of each plane (0 past n): 16-byte
// loads when the planes are 16-byte aligned.
template <int W>
__device__ __forceinline__ void load_rows(const Planes& pl, int64_t first,
                                          int64_t n, bool vec,
                                          int64_t (&r)[W][RL_ROWS]) {
  if (vec && first + RL_ROWS <= n) {
#pragma unroll
    for (int q = 0; q < W; ++q)
#pragma unroll
      for (int v = 0; v < RL_ROWS / 2; ++v) {
        const longlong2 x =
            __ldg(reinterpret_cast<const longlong2*>(pl.w[q] + first) + v);
        r[q][2 * v] = x.x;
        r[q][2 * v + 1] = x.y;
      }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q)
#pragma unroll
      for (int j = 0; j < RL_ROWS; ++j)
        r[q][j] = first + j < n ? __ldg(pl.w[q] + first + j) : 0;
  }
}

// row i's place in its group, i % m (32-bit arithmetic when n allows)
__device__ __forceinline__ int place(int64_t i, int64_t n, int m) {
  return n <= 0xFFFFFFFFll ? (int)((uint32_t)i % (uint32_t)m) : (int)(i % m);
}

// The start and live flags of the RL_ROWS rows from `first` (bit j for row
// first + j; rows past n have neither): a row starts a run at a multiple
// of m or where it differs from the row before it, which comes from the
// lane before by a shuffle (the warp's first row loads it).  All 32 lanes
// of the warp call it.
template <int W>
__device__ __forceinline__ void flag_rows(const Planes& pl, int64_t first,
                                          int64_t n, int m, bool vec,
                                          unsigned& starts, unsigned& live) {
  const int lane = threadIdx.x % 32;
  // the warp's first row loads the row before it with its own rows
  int64_t left[W];
  const bool edge = lane == 0 && first > 0 && first < n;
#pragma unroll
  for (int q = 0; q < W; ++q) left[q] = edge ? __ldg(pl.w[q] + first - 1) : 0;
  int64_t r[W][RL_ROWS];
  load_rows<W>(pl, first, n, vec, r);
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int64_t up = __shfl_up_sync(flag_scan::FULL, r[q][RL_ROWS - 1], 1);
    if (lane != 0) left[q] = up;
  }
  int pos = place(first, n, m);        // the first row's place in its group
  starts = 0;
  live = 0;
#pragma unroll
  for (int j = 0; j < RL_ROWS; ++j) {
    bool st = pos == 0;
#pragma unroll
    for (int q = 0; q < W; ++q)
      st |= r[q][j] != (j ? r[q][j - 1] : left[q]);
    if (first + j < n) {
      starts |= (unsigned)st << j;
      live |= (unsigned)(r[0][j] != SENTINEL) << j;
    }
    pos = pos + 1 == m ? 0 : pos + 1;
  }
}

// The rows [e, e + 32) past a tile, one a lane, and the row before each,
// loaded early so that their latency overlaps the tile's own loads.
template <int W>
struct Ahead {
  int64_t row[W], before[W];

  __device__ __forceinline__ void load(const Planes& pl, int64_t e,
                                       int64_t n) {
    const int64_t i = e + threadIdx.x % 32;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      row[q] = i < n ? __ldg(pl.w[q] + i) : 0;
      before[q] = i < n ? __ldg(pl.w[q] + i - 1) : 0;
    }
  }

  // the first start among the rows: n when they reach n first, -1 when
  // there is none (all 32 lanes)
  __device__ __forceinline__ int64_t first_start(int64_t e, int64_t n,
                                                 int m) const {
    const int64_t i = e + threadIdx.x % 32;
    bool start = i >= n || place(i, n, m) == 0;
#pragma unroll
    for (int q = 0; q < W; ++q) start |= row[q] != before[q];
    const unsigned b = __ballot_sync(flag_scan::FULL, start);
    if (!b) return -1;
    const int64_t f = e + __ffs(b) - 1;
    return f < n ? f : n;
  }
};

// The first start at or after row e (n when there is none), by the whole
// block, RL_TILE rows a step, behind one barrier a step (the per-warp
// firsts alternate between the two rows of buf).  Every group's first row
// is a start, so this takes at most m / RL_TILE + 1 steps.
template <int W>
__device__ int64_t forward_block(const Planes& pl, int64_t e, int64_t n,
                                 int m, bool vec,
                                 int64_t (*buf)[RL_WARPS]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; e < n; ++k, e += RL_TILE) {
    const int64_t first = e + (int64_t)threadIdx.x * RL_ROWS;
    unsigned starts, live;
    flag_rows<W>(pl, first, n, m, vec, starts, live);
    const bool has = starts != 0;
    const int64_t wf = flag_scan::warp_first(
        has, first + (has ? __ffs(starts) - 1 : 0), n);
    if (lane == 0) buf[k & 1][warp] = wf;
    __syncthreads();
    const int64_t f = flag_scan::block_next(buf[k & 1], -1, RL_WARPS, n);
    if (f < n) return f;
  }
  return n;
}

// K2a over the flat rows: a thread owns RL_ROWS consecutive rows; a start's
// count is the distance to the next start (inside the thread's bits, then
// across the warp, then across the block's warps, then past the tile's
// end), or 0 when its word 0 is SENTINEL.
template <int W>
__global__ void __launch_bounds__(RL_THREADS)
run_lengths_kernel(Planes pl, int64_t n, int m, bool vec,
                   int32_t* __restrict__ counts) {
  // each warp's first start (n for none), then the first start among the
  // 32 rows past the tile's end (-1 for none); the forward scan's firsts
  __shared__ int64_t firsts[RL_WARPS + 1];
  __shared__ int64_t scan[2][RL_WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tile = (int64_t)blockIdx.x * RL_TILE;
  const int64_t end = tile + RL_TILE;
  const int64_t first = tile + (int64_t)threadIdx.x * RL_ROWS;
  Ahead<W> ahead;
  if (warp == RL_WARPS - 1 && end < n) ahead.load(pl, end, n);
  unsigned starts, live;
  flag_rows<W>(pl, first, n, m, vec, starts, live);
  if (warp == RL_WARPS - 1) {
    const int64_t f = end < n ? ahead.first_start(end, n, m) : n;
    if (lane == 0) firsts[RL_WARPS] = f;
  }

  // the next start past this thread's rows
  const bool has = starts != 0;
  const int64_t mine = first + (has ? __ffs(starts) - 1 : 0);
  const int64_t wfirst = flag_scan::warp_first(has, mine, n);
  if (lane == 0) firsts[warp] = wfirst;
  __syncthreads();
  int64_t past = firsts[RL_WARPS];
  if (past < 0)                              // the same for the whole block
    past = forward_block<W>(pl, end + 32, n, m, vec, scan);
  const int64_t later = flag_scan::block_next(firsts, warp, RL_WARPS, n);
  const int64_t after =
      flag_scan::warp_next(has, mine, later < past ? later : past);

  int32_t c[RL_ROWS];
#pragma unroll
  for (int j = 0; j < RL_ROWS; ++j) {
    const int b = flag_scan::next_bit_after(starts, j);
    const int64_t next = b >= 0 ? first + b : after;
    c[j] = ((starts & live) >> j) & 1u ? (int32_t)(next - (first + j)) : 0;
  }
  if (first + RL_ROWS <= n) {
    if constexpr (RL_ROWS % 4 == 0) {
#pragma unroll
      for (int v = 0; v < RL_ROWS / 4; ++v)
        reinterpret_cast<int4*>(counts + first)[v] =
            make_int4(c[4 * v], c[4 * v + 1], c[4 * v + 2], c[4 * v + 3]);
    } else {
      reinterpret_cast<int2*>(counts + first)[0] = make_int2(c[0], c[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < RL_ROWS; ++j)
      if (first + j < n) counts[first + j] = c[j];
  }
}

// row a > row b of the shared-memory tile, lexicographically
template <int W>
__device__ __forceinline__ bool tile_gt(const int64_t* s, int rows, int a,
                                        int b) {
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int64_t x = s[q * rows + a], y = s[q * rows + b];
    if (x != y) return x > y;
  }
  return false;
}

template <int W>
__global__ void __launch_bounds__(SORT_THREADS)
grouped_sort_kernel(Planes in, OutPlanes out, int32_t* __restrict__ counts,
                    int64_t G, int m, int log_half, int gpb,
                    int64_t elem_stride, int64_t group_stride) {
  extern __shared__ __align__(16) int64_t s[];
  const int rows = gpb * m;
  const int64_t g0 = (int64_t)blockIdx.x * gpb;
  const int ng = (int)(G - g0 < gpb ? G - g0 : gpb);   // groups in the block
  // element-major walk for strided columns: neighbouring threads take
  // neighbouring groups, which lie side by side in memory
  const bool columns = group_stride == 1 && elem_stride != 1;
  auto place = [&](int t, int& q, int& i) {
    if (columns) {
      i = t / gpb;
      q = t - i * gpb;
    } else {
      q = t / m;
      i = t - q * m;
    }
  };

  for (int t = threadIdx.x; t < rows; t += SORT_THREADS) {
    int q, i;
    place(t, q, i);
    const int r = q * m + i;
    const int64_t e = i * elem_stride + (g0 + q) * group_stride;
#pragma unroll
    for (int w = 0; w < W; ++w)
      s[w * rows + r] = q < ng ? __ldg(in.w[w] + e) : SENTINEL;
  }
  __syncthreads();

  // all-ascending bitonic network inside each group
  const int half = m >> 1;
  for (int kk = 2; kk <= m; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const bool mirror = j == (kk >> 1);
      for (int p = threadIdx.x; p < rows / 2; p += SORT_THREADS) {
        const int q = p >> log_half;
        const int pp = p & (half - 1);
        const int off = pp & (j - 1);
        const int blk = (pp - off) << 1;
        const int lo = q * m + blk + off;
        const int hi = q * m + (mirror ? blk + 2 * j - 1 - off : blk + off + j);
        if (tile_gt<W>(s, rows, lo, hi)) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int64_t a = s[w * rows + lo];
            s[w * rows + lo] = s[w * rows + hi];
            s[w * rows + hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // counts: a run start's run ends at the first greater row of its group
  for (int t = threadIdx.x; t < rows; t += SORT_THREADS) {
    int q, i;
    place(t, q, i);
    if (q >= ng) continue;
    const int r = q * m + i;
    const int64_t e = i * elem_stride + (g0 + q) * group_stride;
    int cnt = 0;
    if (s[r] != SENTINEL && (i == 0 || tile_gt<W>(s, rows, r, r - 1))) {
      int lo = i + 1, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tile_gt<W>(s, rows, q * m + mid, r)) hi = mid;
        else lo = mid + 1;
      }
      cnt = lo - i;
    }
    counts[e] = cnt;
#pragma unroll
    for (int w = 0; w < W; ++w) out.w[w][e] = s[w * rows + r];
  }
}

template <int W>
int run_lengths_rows(Planes pl, int64_t G, int m, int32_t* counts,
                     cudaStream_t st) {
  const int64_t n = G * m;
  const int64_t blocks = (n + RL_TILE - 1) / RL_TILE;
  if (G > INT64_MAX / m || blocks > 0x7FFFFFFF ||
      (reinterpret_cast<uintptr_t>(counts) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  bool vec = true;
  for (int q = 0; q < W; ++q)
    vec &= (reinterpret_cast<uintptr_t>(pl.w[q]) & 15) == 0;
  run_lengths_kernel<W><<<(unsigned)blocks, RL_THREADS, 0, st>>>(pl, n, m,
                                                                 vec, counts);
  return (int)cudaGetLastError();
}

template <int W>
int grouped_sort_rows(Planes in, OutPlanes out, int32_t* counts, int64_t G,
                      int m, int64_t elem_stride, int64_t group_stride,
                      cudaStream_t st) {
  const int gpb = m < MIN_ROWS ? MIN_ROWS / m : 1;
  const size_t smem = (size_t)gpb * m * W * sizeof(int64_t);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_sort_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int log_half = 0;
  while ((1 << log_half) < (m >> 1)) ++log_half;
  const int64_t blocks = (G + gpb - 1) / gpb;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  grouped_sort_kernel<W><<<(unsigned)blocks, SORT_THREADS, smem, st>>>(
      in, out, counts, G, m, log_half, gpb, elem_stride, group_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// K2a. w0..w3: G * m int64 rows, group g at rows [g * m, (g + 1) * m),
// each group sorted (the first W planes used, the rest may be null);
// counts: G * m int32.  1 <= W <= 4, G >= 1, m >= 1.  Returns the launch's
// cudaError_t.
extern "C" int run_lengths_grouped_launch(const int64_t* w0, const int64_t* w1,
                                          const int64_t* w2, const int64_t* w3,
                                          int W, int64_t G, int m,
                                          int32_t* counts, void* stream) {
  Planes pl = {{w0, w1, w2, w3}};
  if (W < 1 || W > 4 || G < 1 || m < 1) return (int)cudaErrorInvalidValue;
  for (int q = 0; q < W; ++q)
    if (pl.w[q] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return run_lengths_rows<1>(pl, G, m, counts, st);
    case 2: return run_lengths_rows<2>(pl, G, m, counts, st);
    case 3: return run_lengths_rows<3>(pl, G, m, counts, st);
    default: return run_lengths_rows<4>(pl, G, m, counts, st);
  }
}

// K2b / K2c. in0..in3 -> out0..out3: G groups of m rows, element i of
// group g at i * elem_stride + g * group_stride (K2b: (1, m); K2c: (G,
// 1)); each group sorted ascending by all W words, and counts (int32, the
// same layout) of its runs.  m a power of two whose gpb-group tile fits a
// block's shared memory.  Returns the first failing call's cudaError_t.
extern "C" int grouped_sort_count_launch(
    const int64_t* in0, const int64_t* in1, const int64_t* in2,
    const int64_t* in3, int64_t* out0, int64_t* out1, int64_t* out2,
    int64_t* out3, int W, int64_t G, int m, int64_t elem_stride,
    int64_t group_stride, int32_t* counts, void* stream) {
  Planes in = {{in0, in1, in2, in3}};
  OutPlanes out = {{out0, out1, out2, out3}};
  if (W < 1 || W > 4 || G < 1 || m < 1 || (m & (m - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < W; ++q)
    if (in.w[q] == nullptr || out.w[q] == nullptr)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return grouped_sort_rows<1>(in, out, counts, G, m, elem_stride,
                                        group_stride, st);
    case 2: return grouped_sort_rows<2>(in, out, counts, G, m, elem_stride,
                                        group_stride, st);
    case 3: return grouped_sort_rows<3>(in, out, counts, G, m, elem_stride,
                                        group_stride, st);
    default: return grouped_sort_rows<4>(in, out, counts, G, m, elem_stride,
                                         group_stride, st);
  }
}
