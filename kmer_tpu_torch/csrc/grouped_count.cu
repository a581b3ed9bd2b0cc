// Grouped run lengths and grouped sort + run lengths for Hopper (sm_90a),
// over W int64 word planes, 1 <= W <= MAX_PLANES (a row is (w0[e], ...,
// w{W-1}[e]), compared lexicographically as signed int64, word 0 most
// significant; a row whose word 0 is SENTINEL = INT64_MAX is a dead lane).
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
// What bounds them: memory, each row read once and written once with an
// int32 count (K2a reads and counts), where the sort's compare-exchanges
// stay in registers: m log2(m)^2 / 4 of them a group of m, W words each.
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
// Here each group comes out sorted by ALL W words (equal to a stable
// sort's), with its counts, from one of three bodies chosen by shape:
// - the column body (strided columns, m <= 32, m W <= COL_WORDS: K2c's
//   route, m = 16): a thread holds a whole group in registers and sorts it
//   with Batcher's odd-even merge network unrolled at compile time (63
//   compare-exchanges at m = 16); element i of 32 neighbouring groups is
//   one coalesced warp load and store, so no shared memory and no barrier;
// - the warp body (contiguous groups, 2 <= m <= 32 WARP_ROWS: K2b's route,
//   m = 256): a warp sorts a span of 32 R rows (warp_rows: 8 / W, at least
//   m / 32 and 2), lane l holding ranks [l R, (l + 1) R) in registers;
//   bitonic stages of distance j < R run inside the lane (the first
//   log2(R) merges unrolled), the others by a shuffle with lane l ^ (j / R)
//   (15 of 36 at m = 256, R = 8).  Run starts compare with the rank
//   before (a shuffle for a lane's first), and a start's next start comes
//   from the lane's flag bits or flag_scan.cuh's ballot, not a search.
//   The span goes in and out as 16-byte vectors over 512 contiguous bytes
//   a warp instruction, through the warp's own slice of shared memory
//   (XOR-swizzled: no bank conflict) where a lane's rows of a plane are
//   more than 16 bytes; only __syncwarp orders it;
// - the block body (every other shape, up to max_group_rows(W) in the
//   wrapper): a block loads gpb whole groups (gpb m >= MIN_ROWS rows)
//   into shared memory at a pitch of m + 1 rows, sorts each with the
//   all-ascending bitonic network of csrc/sort.cu behind a barrier a
//   stage, and finds a run start's end by a binary search.  Over 48 KB of
//   shared memory the launch needs cudaFuncSetAttribute first.
// The column and warp bodies run on a grid of the card's resident blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads or warps
// taking groups or spans in turn, with 64-bit offsets.
// Widths: the planes travel by value as structs of MAX_PLANES pointers.
// K2a and the block body are unrolled for W <= 4 and loop over the planes
// beyond (template argument W = 0), K2a comparing a row with the one
// before it one plane at a time, so any W runs in the same registers; the
// column and warp bodies, whose registers hold whole rows, take W <= 4,
// and wider rows take the block body (a group of m rows must fit a
// block's shared memory, max_group_rows(W) in the wrapper).

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
constexpr int COL_THREADS = 128;             // column body: threads a block
constexpr int COL_WORDS = 64;                // its int64 words a column at most
constexpr int WARP_THREADS = 128;            // warp body: threads a block
constexpr int WARP_WORDS = 32;               // its int64 words a lane at most
constexpr int WARP_ROWS = 32;                // and its rows a lane
constexpr int WARP_LANE_WORDS = 8;           // words a lane where m allows
constexpr int SORT_THREADS = 512;            // block body: threads a block
constexpr int MIN_ROWS = 2048;                 // rows a sort block takes at least
constexpr int SMEM_MAX = 232448;               // 227 KB: a block's shared memory

constexpr int MAX_PLANES = 128;
struct Planes {
  const int64_t* w[MAX_PLANES];
};
struct OutPlanes {
  int64_t* w[MAX_PLANES];
};

// The rows [first, first + RL_ROWS) of a plane (0 past n): 16-byte loads
// when the planes are 16-byte aligned.
__device__ __forceinline__ void load_rows(const int64_t* p, int64_t first,
                                          int64_t n, bool vec,
                                          int64_t (&r)[RL_ROWS]) {
  if (vec && first + RL_ROWS <= n) {
#pragma unroll
    for (int v = 0; v < RL_ROWS / 2; ++v) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p + first) +
                                v);
      r[2 * v] = x.x;
      r[2 * v + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RL_ROWS; ++j)
      r[j] = first + j < n ? __ldg(p + first + j) : 0;
  }
}

// row i's place in its group, i % m (32-bit arithmetic when n allows)
__device__ __forceinline__ int place(int64_t i, int64_t n, int m) {
  return n <= 0xFFFFFFFFll ? (int)((uint32_t)i % (uint32_t)m) : (int)(i % m);
}

// The start and live flags of the RL_ROWS rows from `first` (bit j for row
// first + j; rows past n have neither): a row starts a run at a multiple
// of m or where it differs from the row before it, which comes from the
// lane before by a shuffle (the warp's first row loads it), one plane at a
// time (W > 0: W planes, unrolled; W == 0: nw).  All 32 lanes of the warp
// call it.
template <int W>
__device__ __forceinline__ void flag_rows(const Planes& pl, int nw,
                                          int64_t first, int64_t n, int m,
                                          bool vec, unsigned& starts,
                                          unsigned& live) {
  const int lane = threadIdx.x % 32;
  const int NW = W > 0 ? W : nw;
  // the warp's first row loads the row before it with its own rows
  const bool edge = lane == 0 && first > 0 && first < n;
  unsigned diff = 0, real = 0;   // bit j: row first + j differs; is live
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    int64_t left = edge ? __ldg(pl.w[q] + first - 1) : 0;
    int64_t r[RL_ROWS];
    load_rows(pl.w[q], first, n, vec, r);
    const int64_t up = __shfl_up_sync(flag_scan::FULL, r[RL_ROWS - 1], 1);
    if (lane != 0) left = up;
#pragma unroll
    for (int j = 0; j < RL_ROWS; ++j) {
      diff |= (unsigned)(r[j] != (j ? r[j - 1] : left)) << j;
      if (q == 0) real |= (unsigned)(r[j] != SENTINEL) << j;
    }
  }
  int pos = place(first, n, m);        // the first row's place in its group
  starts = 0;
  live = 0;
#pragma unroll
  for (int j = 0; j < RL_ROWS; ++j) {
    if (first + j < n) {
      starts |= (unsigned)(pos == 0 || (diff >> j & 1u)) << j;
      live |= real & (1u << j);
    }
    pos = pos + 1 == m ? 0 : pos + 1;
  }
}

// The rows [e, e + 32) past a tile, one a lane, and the row before each,
// loaded early so that their latency overlaps the tile's own loads (W >
// 0); with W == 0 the nw planes are compared as they load.
template <int W>
struct Ahead {
  static constexpr int H = W > 0 ? W : 1;
  int64_t row[H], before[H];
  bool diff = false;

  __device__ __forceinline__ void load(const Planes& pl, int nw, int64_t e,
                                       int64_t n) {
    const int64_t i = e + threadIdx.x % 32;
    if constexpr (W > 0) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        row[q] = i < n ? __ldg(pl.w[q] + i) : 0;
        before[q] = i < n ? __ldg(pl.w[q] + i - 1) : 0;
      }
    } else {
      for (int q = 0; q < nw && i < n; ++q)
        diff |= __ldg(pl.w[q] + i) != __ldg(pl.w[q] + i - 1);
    }
  }

  // the first start among the rows: n when they reach n first, -1 when
  // there is none (all 32 lanes)
  __device__ __forceinline__ int64_t first_start(int64_t e, int64_t n,
                                                 int m) const {
    const int64_t i = e + threadIdx.x % 32;
    bool start = i >= n || place(i, n, m) == 0 || diff;
#pragma unroll
    for (int q = 0; q < (W > 0 ? W : 0); ++q) start |= row[q] != before[q];
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
__device__ int64_t forward_block(const Planes& pl, int nw, int64_t e, int64_t n,
                                 int m, bool vec,
                                 int64_t (*buf)[RL_WARPS]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; e < n; ++k, e += RL_TILE) {
    const int64_t first = e + (int64_t)threadIdx.x * RL_ROWS;
    unsigned starts, live;
    flag_rows<W>(pl, nw, first, n, m, vec, starts, live);
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
run_lengths_kernel(Planes pl, int nw, int64_t n, int m, bool vec,
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
  if (warp == RL_WARPS - 1 && end < n) ahead.load(pl, nw, end, n);
  unsigned starts, live;
  flag_rows<W>(pl, nw, first, n, m, vec, starts, live);
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
    past = forward_block<W>(pl, nw, end + 32, n, m, vec, scan);
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

// ------------------------------------------------------------- K2b / K2c

// row a > row b, lexicographically over W signed words (word 0 most
// significant), with no branch
template <int W>
__device__ __forceinline__ bool row_gt(const int64_t (&a)[W],
                                       const int64_t (&b)[W]) {
  bool gt = false, eq = true;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    gt |= eq && a[q] > b[q];
    eq &= a[q] == b[q];
  }
  return gt;
}

// a <- min(a, b) and b <- max(a, b) when up, the other way round when not
// (rows equal in every word swap to themselves, so one compare serves
// both directions)
template <int W>
__device__ __forceinline__ void exchange(int64_t (&a)[W], int64_t (&b)[W],
                                         bool up) {
  const bool swap = row_gt<W>(a, b) == up;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int64_t x = a[q], y = b[q];
    a[q] = swap ? y : x;
    b[q] = swap ? x : y;
  }
}

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// Batcher's odd-even merge sort of the rows LO..HI (both included),
// unrolled at compile time into f.ce<A, B>() (A < B: the smaller row to
// A).  oe_merge<LO, HI, R> merges the two sorted halves of the rows LO,
// LO + R, ..., HI.
template <int I, int END, int STEP, int R, class F>
__device__ __forceinline__ void oe_pairs(F& f) {
  if constexpr (I < END) {
    f.template ce<I, I + R>();
    oe_pairs<I + STEP, END, STEP, R>(f);
  }
}

template <int LO, int HI, int R, class F>
__device__ __forceinline__ void oe_merge(F& f) {
  constexpr int STEP = 2 * R;
  if constexpr (STEP < HI - LO) {
    oe_merge<LO, HI, STEP>(f);
    oe_merge<LO + R, HI, STEP>(f);
    oe_pairs<LO + R, HI - R, STEP, R>(f);
  } else {
    f.template ce<LO, LO + R>();
  }
}

template <int LO, int HI, class F>
__device__ __forceinline__ void oe_sort(F& f) {
  if constexpr (HI > LO) {
    constexpr int MID = LO + (HI - LO) / 2;
    oe_sort<LO, MID>(f);
    oe_sort<MID + 1, HI>(f);
    oe_merge<LO, HI, 1>(f);
  }
}

// one group of M rows in a thread's registers
template <int M, int W>
struct Column {
  int64_t x[M][W];

  template <int A, int B>
  __device__ __forceinline__ void ce() {
    exchange<W>(x[A], x[B], true);
  }

  // a live run start's count is the distance to the next start (M past
  // the last row), every other row's 0; from the last row back
  __device__ __forceinline__ void count(int32_t (&c)[M]) const {
    int next = M;
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      bool start = i == 0;
#pragma unroll
      for (int q = 0; q < W; ++q)
        start |= i > 0 && x[i][q] != x[i > 0 ? i - 1 : 0][q];
      c[i] = start && x[i][0] != SENTINEL ? next - i : 0;
      next = start ? i : next;
    }
  }
};

// The column body: a thread sorts one group of M rows, element i at
// i * stride + g, in registers with no shared memory and no barrier; its
// M loads and stores are each a warp instruction over 32 neighbouring
// groups, 256 contiguous bytes a plane.  Threads take the groups in turn
// over a grid of the card's resident blocks.
template <int M, int W>
__global__ void __launch_bounds__(COL_THREADS)
column_sort_kernel(Planes in, OutPlanes out, int32_t* __restrict__ counts,
                   int64_t G, int64_t stride) {
  for (int64_t g = (int64_t)blockIdx.x * COL_THREADS + threadIdx.x; g < G;
       g += (int64_t)gridDim.x * COL_THREADS) {
    Column<M, W> c;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int q = 0; q < W; ++q) c.x[i][q] = __ldg(in.w[q] + i * stride + g);
    oe_sort<0, M - 1>(c);
    int32_t cnt[M];
    c.count(cnt);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int64_t e = i * stride + g;
#pragma unroll
      for (int q = 0; q < W; ++q) out.w[q][e] = c.x[i][q];
      counts[e] = cnt[i];
    }
  }
}

// The warp body's slot of 16-byte chunk q of a span in its warp's shared
// slice, when each lane writes C consecutive chunks: q ^ ((q / C) & 7)
// keeps the 8 lanes of a quarter-warp's 16-byte accesses on 8 different
// 16-byte bank groups, both for lane l's chunk l C + c and for the
// consecutive chunks of a coalesced walk (C = 1: no swizzle needed).
template <int C>
__device__ __forceinline__ int chunk_slot(int q) {
  return C >= 2 ? q ^ ((q / C) & 7) : q;
}

// rows row and row + 1 of a plane (SENTINEL past n; n is even)
__device__ __forceinline__ longlong2 load_pair(const int64_t* p, int64_t row,
                                               int64_t n, bool vec) {
  if (row >= n) return make_longlong2(SENTINEL, SENTINEL);
  if (vec) return __ldg(reinterpret_cast<const longlong2*>(p + row));
  return make_longlong2(__ldg(p + row), __ldg(p + row + 1));
}

__device__ __forceinline__ void store_pair(int64_t* p, int64_t row,
                                           longlong2 v, bool vec) {
  if (vec) {
    reinterpret_cast<longlong2*>(p + row)[0] = v;
  } else {
    p[row] = v.x;
    p[row + 1] = v.y;
  }
}

// The span [base, base + 32 R) into the lanes' registers, lane l holding
// ranks [l R, (l + 1) R): R = 2 straight from device memory (a lane's
// 16-byte vector, 512 contiguous bytes a warp instruction), R >= 4
// through the warp's shared slice (coalesced 16-byte loads in, the lane's
// own chunks out).
template <int R, int W>
__device__ __forceinline__ void load_span(const Planes& in, int64_t base,
                                          int64_t n, bool vec,
                                          longlong2* slice,
                                          int64_t (&x)[R][W]) {
  const int lane = threadIdx.x % 32;
  constexpr int C = R / 2, CHUNKS = 16 * R;    // chunks a lane, a span
  longlong2 v[C][W];
#pragma unroll
  for (int t = 0; t < C; ++t)
#pragma unroll
    for (int q = 0; q < W; ++q)
      v[t][q] = load_pair(in.w[q], base + 2 * (lane + 32 * t), n, vec);
  if constexpr (R == 2) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      x[0][q] = v[0][q].x;
      x[1][q] = v[0][q].y;
    }
  } else {
    __syncwarp();                // the slice's last span is out
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
      for (int q = 0; q < W; ++q)
        slice[q * CHUNKS + chunk_slot<C>(lane + 32 * t)] = v[t][q];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const longlong2 r = slice[q * CHUNKS + chunk_slot<C>(lane * C + c)];
        x[2 * c][q] = r.x;
        x[2 * c + 1][q] = r.y;
      }
  }
}

// The bitonic network over groups of m rows of the span (ascending from
// the last merge of a group, kk = m; before it a block of kk ranks runs
// down when its rank bit kk is set).  The merges of kk <= R ranks lie
// inside a lane: unrolled, their directions known but for kk == m.  Above
// them a stage of distance j >= R pairs lane l's register k with lane
// l ^ (j / R)'s register k by a shuffle, and a stage of j < R a lane's
// registers k and k + j, every one in the lane's direction.
template <int R, int W>
__device__ __forceinline__ void sort_span(int64_t (&x)[R][W], int m) {
  const int lane = threadIdx.x % 32;
  constexpr int LOG_R = log2_of(R);
#pragma unroll
  for (int lk = 1; lk <= LOG_R; ++lk) {
    const int kk = 1 << lk;
    if (kk > m) break;                 // groups of fewer rows than R
    const bool last = kk == m;
#pragma unroll
    for (int s = lk - 1; s >= 0; --s) {
      const int j = 1 << s;
#pragma unroll
      for (int k = 0; k < R; ++k)
        if ((k & j) == 0)
          exchange<W>(x[k], x[k + j],
                      last || (kk < R ? (k & kk) == 0
                                      : ((lane * R) & kk) == 0));
    }
  }
  for (int kk = 2 * R; kk <= m; kk <<= 1) {
    const bool up = kk == m || ((lane * R) & kk) == 0;
    for (int j = kk >> 1; j >= R; j >>= 1) {
      const int lm = j / R;
      // the lower rank keeps the smaller row going up, the larger going
      // down
      const bool keep_min = ((lane & lm) == 0) == up;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        int64_t y[W];
#pragma unroll
        for (int q = 0; q < W; ++q)
          y[q] = __shfl_xor_sync(flag_scan::FULL, x[k][q], lm);
        const bool take = keep_min == row_gt<W>(x[k], y);
#pragma unroll
        for (int q = 0; q < W; ++q) x[k][q] = take ? y[q] : x[k][q];
      }
    }
#pragma unroll
    for (int s = LOG_R - 1; s >= 0; --s) {
      const int j = 1 << s;
#pragma unroll
      for (int k = 0; k < R; ++k)
        if ((k & j) == 0) exchange<W>(x[k], x[k + j], up);
    }
  }
}

// Counts of the sorted span: rank r starts a run at a multiple of m or
// where its row differs from rank r - 1's (register k - 1, or the lane
// before's last by a shuffle); a start's next start is in the lane's own
// flag bits, else the first start of a later lane (a ballot, then
// warp_next), else the span's end, a group's end.
template <int R, int W>
__device__ __forceinline__ void count_span(const int64_t (&x)[R][W], int m,
                                           int32_t (&c)[R]) {
  const int lane = threadIdx.x % 32;
  int64_t prev[W];
#pragma unroll
  for (int q = 0; q < W; ++q)
    prev[q] = __shfl_up_sync(flag_scan::FULL, x[R - 1][q], 1);
  unsigned starts = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bool st = ((lane * R + k) & (m - 1)) == 0;
#pragma unroll
    for (int q = 0; q < W; ++q)
      st |= x[k][q] != (k > 0 ? x[k > 0 ? k - 1 : 0][q] : prev[q]);
    starts |= (unsigned)st << k;
  }
  const bool has = starts != 0;
  const int mine = lane * R + (has ? __ffs(starts) - 1 : 0);
  const int after = flag_scan::warp_next(has, mine, 32 * R);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int b = flag_scan::next_bit_after(starts, k);
    const int next = b >= 0 ? lane * R + b : after;
    c[k] = (starts >> k) & 1u && x[k][0] != SENTINEL
               ? next - (lane * R + k) : 0;
  }
}

// The sorted span and its counts back to device memory, each warp
// instruction's 16-byte stores covering 512 contiguous bytes: straight
// from the registers where a lane's rows of a plane are 16 bytes (keys at
// R = 2) and its counts at most 16 (R <= 4), else through the slice.
template <int R, int W>
__device__ __forceinline__ void store_span(const OutPlanes& out,
                                           int32_t* counts, int64_t base,
                                           int64_t n, bool vec,
                                           longlong2* slice,
                                           const int64_t (&x)[R][W],
                                           const int32_t (&c)[R]) {
  const int lane = threadIdx.x % 32;
  constexpr int C = R / 2, CHUNKS = 16 * R;
  if constexpr (R == 2) {
    const int64_t row = base + 2 * lane;
    if (row < n) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        store_pair(out.w[q], row, make_longlong2(x[0][q], x[1][q]), vec);
      if (vec) {
        reinterpret_cast<int2*>(counts + row)[0] = make_int2(c[0], c[1]);
      } else {
        counts[row] = c[0];
        counts[row + 1] = c[1];
      }
    }
    return;
  } else {
    __syncwarp();                // every lane's rows are out of the slice
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int q = 0; q < W; ++q)
        slice[q * CHUNKS + chunk_slot<C>(lane * C + k)] =
            make_longlong2(x[2 * k][q], x[2 * k + 1][q]);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int64_t row = base + 2 * (lane + 32 * t);
      if (row < n) {
#pragma unroll
        for (int q = 0; q < W; ++q)
          store_pair(out.w[q], row,
                     slice[q * CHUNKS + chunk_slot<C>(lane + 32 * t)], vec);
      }
    }
    if constexpr (R == 4) {
      const int64_t row = base + 4 * lane;
      if (row < n) {
        if (vec) {
          reinterpret_cast<int4*>(counts + row)[0] =
              make_int4(c[0], c[1], c[2], c[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) counts[row + k] = c[k];
        }
      }
    } else {
      constexpr int D = R / 4;              // 16-byte count chunks a lane
      int4* cs = reinterpret_cast<int4*>(slice);
      __syncwarp();              // the key chunks are out of the slice
#pragma unroll
      for (int d = 0; d < D; ++d)
        cs[chunk_slot<D>(lane * D + d)] =
            make_int4(c[4 * d], c[4 * d + 1], c[4 * d + 2], c[4 * d + 3]);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < D; ++t) {
        const int64_t row = base + 4 * (lane + 32 * t);
        if (row < n) {
          const int4 v = cs[chunk_slot<D>(lane + 32 * t)];
          if (vec) {
            reinterpret_cast<int4*>(counts + row)[0] = v;
          } else {
            counts[row] = v.x;
            counts[row + 1] = v.y;
            counts[row + 2] = v.z;
            counts[row + 3] = v.w;
          }
        }
      }
    }
  }
}

// The warp body: contiguous groups of m rows (2 <= m <= 32 R), n = G m
// rows; each warp sorts a span of 32 R rows (32 R / m whole groups) at a
// time, the spans taken in turn over a grid of the card's resident
// blocks; no block barrier.
template <int R, int W>
__global__ void __launch_bounds__(WARP_THREADS)
warp_sort_kernel(Planes in, OutPlanes out, int32_t* __restrict__ counts,
                 int64_t n, int m, bool vec) {
  extern __shared__ __align__(16) longlong2 slices[];
  constexpr int WARPS = WARP_THREADS / 32, S = 32 * R;
  const int warp = threadIdx.x / 32;
  longlong2* slice = slices + (size_t)warp * (S / 2) * W;
  const int64_t spans = (n + S - 1) / S;
  for (int64_t sp = (int64_t)blockIdx.x * WARPS + warp; sp < spans;
       sp += (int64_t)gridDim.x * WARPS) {
    const int64_t base = sp * S;
    int64_t x[R][W];
    load_span<R, W>(in, base, n, vec, slice, x);
    sort_span<R, W>(x, m);
    int32_t c[R];
    count_span<R, W>(x, m, c);
    store_span<R, W>(out, counts, base, n, vec, slice, x, c);
  }
}

// row a > row b of the shared-memory tile, lexicographically over its W
// words (W == 0: nw)
template <int W>
__device__ __forceinline__ bool tile_gt(const int64_t* s, int nw, int rows,
                                        int a, int b) {
#pragma unroll
  for (int q = 0; q < (W > 0 ? W : nw); ++q) {
    const int64_t x = s[q * rows + a], y = s[q * rows + b];
    if (x != y) return x > y;
  }
  return false;
}

// The block body (every other shape: m past the other bodies' reach): a
// block loads gpb whole groups into shared memory, each group at a stride
// of m + 1 rows so that the strided-column walk's neighbouring threads
// (neighbouring groups) fall on different banks, sorts each by the
// all-ascending bitonic network behind a barrier a stage, and finds each
// run start's end by a binary search in its group.
template <int W>
__global__ void __launch_bounds__(SORT_THREADS)
block_sort_kernel(Planes in, OutPlanes out, int32_t* __restrict__ counts,
                  int nw, int64_t G, int m, int log_half, int gpb,
                  int64_t elem_stride, int64_t group_stride) {
  const int NW = W > 0 ? W : nw;
  extern __shared__ __align__(16) int64_t s[];
  // element-major walk for strided columns: neighbouring threads take
  // neighbouring groups, which lie side by side in memory
  const bool columns = group_stride == 1 && elem_stride != 1;
  const int pitch = m + 1;                     // a group's rows in s
  const int rows = gpb * pitch;                // a plane's rows in s
  const int64_t g0 = (int64_t)blockIdx.x * gpb;
  const int ng = (int)(G - g0 < gpb ? G - g0 : gpb);   // groups in the block
  auto place = [&](int t, int& q, int& i) {
    if (columns) {
      i = t / gpb;
      q = t - i * gpb;
    } else {
      q = t / m;
      i = t - q * m;
    }
  };

  for (int t = threadIdx.x; t < gpb * m; t += SORT_THREADS) {
    int q, i;
    place(t, q, i);
    const int r = q * pitch + i;
    const int64_t e = i * elem_stride + (g0 + q) * group_stride;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      s[w * rows + r] = q < ng ? __ldg(in.w[w] + e) : SENTINEL;
  }
  __syncthreads();

  // all-ascending bitonic network inside each group
  const int half = m >> 1;
  for (int kk = 2; kk <= m; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const bool mirror = j == (kk >> 1);
      for (int p = threadIdx.x; p < gpb * half; p += SORT_THREADS) {
        const int q = p >> log_half;
        const int pp = p & (half - 1);
        const int off = pp & (j - 1);
        const int blk = (pp - off) << 1;
        const int lo = q * pitch + blk + off;
        const int hi =
            q * pitch + (mirror ? blk + 2 * j - 1 - off : blk + off + j);
        if (tile_gt<W>(s, nw, rows, lo, hi)) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
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
  for (int t = threadIdx.x; t < gpb * m; t += SORT_THREADS) {
    int q, i;
    place(t, q, i);
    if (q >= ng) continue;
    const int r = q * pitch + i;
    const int64_t e = i * elem_stride + (g0 + q) * group_stride;
    int cnt = 0;
    if (s[r] != SENTINEL && (i == 0 || tile_gt<W>(s, nw, rows, r, r - 1))) {
      int lo = i + 1, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tile_gt<W>(s, nw, rows, q * pitch + mid, r)) hi = mid;
        else lo = mid + 1;
      }
      cnt = lo - i;
    }
    counts[e] = cnt;
#pragma unroll
    for (int w = 0; w < NW; ++w) out.w[w][e] = s[w * rows + r];
  }
}

template <int W>
int run_lengths_rows(const Planes& pl, int nw, int64_t G, int m,
                     int32_t* counts, cudaStream_t st) {
  const int64_t n = G * m;
  const int64_t blocks = (n + RL_TILE - 1) / RL_TILE;
  if (G > INT64_MAX / m || blocks > 0x7FFFFFFF ||
      (reinterpret_cast<uintptr_t>(counts) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  bool vec = true;
  for (int q = 0; q < nw; ++q)
    vec &= (reinterpret_cast<uintptr_t>(pl.w[q]) & 15) == 0;
  run_lengths_kernel<W><<<(unsigned)blocks, RL_THREADS, 0, st>>>(
      pl, nw, n, m, vec, counts);
  return (int)cudaGetLastError();
}

// The bodies and the launch's report: info[0 .. 8) = threads a block,
// blocks, dynamic shared bytes, registers a thread, local (spill) bytes,
// resident blocks an SM, the cudaError_t of the queries, and the body
enum Body { COLUMN = 0, WARP = 1, BLOCK = 2 };
constexpr int INFO_INTS = 8;

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Launch kern over `need` blocks of `threads` (with fill, no more than the
// card's resident blocks: the bodies then take their units in turn), or
// with info set report that launch instead.
template <typename... P, typename... A>
int run(void (*kern)(P...), int body, int threads, size_t smem, int64_t need,
        bool fill, cudaStream_t st, int* info, A... args) {
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = need;
  if (fill) {
    const int64_t card = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
    blocks = need < card ? need : card;
  }
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (info != nullptr) {
    cudaFuncAttributes a = {};
    e = cudaFuncGetAttributes(&a, kern);
    const int v[INFO_INTS] = {threads, (int)blocks, (int)smem, a.numRegs,
                              (int)a.localSizeBytes, per_sm, (int)e, body};
    for (int i = 0; i < INFO_INTS; ++i) info[i] = v[i];
    return (int)e;
  }
  kern<<<(unsigned)blocks, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

struct Args {
  Planes in;
  OutPlanes out;
  int32_t* counts;
  int64_t G, elem_stride, group_stride;
  int m, nw;
  bool vec;                        // every plane and the counts 16-byte aligned
  cudaStream_t st;
  int* info;
};

template <int M, int W>
int column_launch(const Args& a) {
  if constexpr (M * W > COL_WORDS) {
    return (int)cudaErrorInvalidValue;
  } else {
    return run(column_sort_kernel<M, W>, COLUMN, COL_THREADS, 0,
               (a.G + COL_THREADS - 1) / COL_THREADS, true, a.st, a.info,
               a.in, a.out, a.counts, a.G, a.elem_stride);
  }
}

template <int W>
int column_m(const Args& a) {
  switch (a.m) {
    case 1: return column_launch<1, W>(a);
    case 2: return column_launch<2, W>(a);
    case 4: return column_launch<4, W>(a);
    case 8: return column_launch<8, W>(a);
    case 16: return column_launch<16, W>(a);
    case 32: return column_launch<32, W>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int R, int W>
int warp_launch(const Args& a) {
  if constexpr (R * W > WARP_WORDS) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int S = 32 * R, WARPS = WARP_THREADS / 32;
    const int64_t n = a.G * a.m;
    const int64_t spans = (n + S - 1) / S;
    const size_t smem = R >= 4 ? (size_t)WARPS * S * W * sizeof(int64_t) : 0;
    return run(warp_sort_kernel<R, W>, WARP, WARP_THREADS, smem,
               (spans + WARPS - 1) / WARPS, true, a.st, a.info, a.in, a.out,
               a.counts, n, a.m, a.vec);
  }
}

template <int W>
int warp_r(const Args& a, int R) {
  switch (R) {
    case 2: return warp_launch<2, W>(a);
    case 4: return warp_launch<4, W>(a);
    case 8: return warp_launch<8, W>(a);
    case 16: return warp_launch<16, W>(a);
    case 32: return warp_launch<32, W>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// groups a block: MIN_ROWS rows' worth, as many as shared memory holds
template <int W>
int block_launch(const Args& a) {
  const size_t group = (size_t)(a.m + 1) * a.nw * sizeof(int64_t);
  int gpb = a.m < MIN_ROWS ? MIN_ROWS / a.m : 1;
  while (gpb > 1 && gpb * group > (size_t)SMEM_MAX) gpb >>= 1;
  return run(block_sort_kernel<W>, BLOCK, SORT_THREADS, gpb * group,
             (a.G + gpb - 1) / gpb, false, a.st, a.info, a.in, a.out,
             a.counts, a.nw, a.G, a.m, log2_of(a.m >> 1), gpb,
             a.elem_stride, a.group_stride);
}

// The warp body's rows a lane for groups of m rows and W words: the power
// of two of WARP_LANE_WORDS / W or less, no more than m (a group over
// m / R lanes), at least max(2, m / 32) (a group over 32 lanes at most);
// 0 when that passes WARP_ROWS or WARP_WORDS.
inline int warp_rows(int m, int W) {
  int R = WARP_LANE_WORDS / W < m ? WARP_LANE_WORDS / W : m;
  while (R & (R - 1)) R &= R - 1;
  const int least = m / 32 > 2 ? m / 32 : 2;
  R = R > least ? R : least;
  return R <= WARP_ROWS && R * W <= WARP_WORDS ? R : 0;
}

// The body for a shape: strided columns (group stride 1) of m <= 32 rows
// whose m W words fit COL_WORDS take the column body; contiguous groups
// (element stride 1) of m >= 2 rows that warp_rows fits the warp body;
// every other shape the block body.
template <int W>
int sort_rows(const Args& a) {
  const int m = a.m;
  if (a.group_stride == 1 && m <= 32 && m * W <= COL_WORDS)
    return column_m<W>(a);
  const int R = warp_rows(m, W);
  if (a.elem_stride == 1 && a.group_stride == m && m >= 2 && R > 0)
    return warp_r<W>(a, R);
  return block_launch<W>(a);
}

int sort_or_report(const int64_t* const* in, int64_t* const* out, int W,
                   int64_t G, int m, int64_t elem_stride,
                   int64_t group_stride, int32_t* counts, void* stream,
                   int* info) {
  if (W < 1 || W > MAX_PLANES || G < 1 || m < 1 || (m & (m - 1)) != 0 ||
      G > INT64_MAX / m)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  bool vec = true;
  for (int q = 0; q < W && info == nullptr; ++q) {
    if (in[q] == nullptr || out[q] == nullptr)
      return (int)cudaErrorInvalidValue;
    a.in.w[q] = in[q];
    a.out.w[q] = out[q];
    vec &= (reinterpret_cast<uintptr_t>(in[q]) & 15) == 0 &&
           (reinterpret_cast<uintptr_t>(out[q]) & 15) == 0;
  }
  a.counts = counts;
  a.G = G;
  a.m = m;
  a.nw = W;
  a.elem_stride = elem_stride;
  a.group_stride = group_stride;
  a.vec = vec && (reinterpret_cast<uintptr_t>(counts) & 15) == 0;
  a.st = static_cast<cudaStream_t>(stream);
  a.info = info;
  switch (W) {
    case 1: return sort_rows<1>(a);
    case 2: return sort_rows<2>(a);
    case 3: return sort_rows<3>(a);
    case 4: return sort_rows<4>(a);
    default: return block_launch<0>(a);
  }
}

}  // namespace

extern "C" int grouped_max_planes() { return MAX_PLANES; }

// K2a. planes: W host pointers to G * m int64 rows, group g at rows
// [g * m, (g + 1) * m), each group sorted; counts: G * m int32.  1 <= W <=
// MAX_PLANES, G >= 1, m >= 1.  Returns the launch's cudaError_t.
extern "C" int run_lengths_grouped_launch(const int64_t* const* planes, int W,
                                          int64_t G, int m, int32_t* counts,
                                          void* stream) {
  if (W < 1 || W > MAX_PLANES || G < 1 || m < 1 || planes == nullptr)
    return (int)cudaErrorInvalidValue;
  Planes pl = {};
  for (int q = 0; q < W; ++q) {
    if (planes[q] == nullptr) return (int)cudaErrorInvalidValue;
    pl.w[q] = planes[q];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return run_lengths_rows<1>(pl, W, G, m, counts, st);
    case 2: return run_lengths_rows<2>(pl, W, G, m, counts, st);
    case 3: return run_lengths_rows<3>(pl, W, G, m, counts, st);
    case 4: return run_lengths_rows<4>(pl, W, G, m, counts, st);
    default: return run_lengths_rows<0>(pl, W, G, m, counts, st);
  }
}

// K2b / K2c. in -> out: W host pointers each to G groups of m rows, element
// i of group g at i * elem_stride + g * group_stride (K2b: (1, m); K2c: (G,
// 1)); each group sorted ascending by all W words, and counts (int32, the
// same layout) of its runs.  m a power of two; the block body's groups
// must fit a block's shared memory (m + 1 rows of W words).  Returns the
// launch's cudaError_t.
extern "C" int grouped_sort_count_launch(const int64_t* const* in,
                                         int64_t* const* out, int W,
                                         int64_t G, int m,
                                         int64_t elem_stride,
                                         int64_t group_stride,
                                         int32_t* counts, void* stream) {
  if (in == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  return sort_or_report(in, out, W, G, m, elem_stride, group_stride, counts,
                        stream, nullptr);
}

// The launch grouped_sort_count_launch would make for the shape, without
// making it: info[0 .. 8) as above.  Returns its cudaError_t.
extern "C" int grouped_sort_info(int W, int64_t G, int m,
                                 int64_t elem_stride, int64_t group_stride,
                                 int* info) {
  return sort_or_report(nullptr, nullptr, W, G, m, elem_stride, group_stride,
                        nullptr, nullptr, info);
}
