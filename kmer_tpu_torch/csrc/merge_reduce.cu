// Run totals and compaction of the device merge for Hopper (sm_90a): the
// R = C + N rows of a merge, sorted by K6 (W int64 key words, int64
// counts), reduced to one row a distinct real key, in key order, with its
// run's total, written to the front of a new C-row state padded with
// sentinel rows; and the number of distinct keys, left on the device.
//
// Replaces no Pallas kernel: kmer_tpu's merge computes its run totals in
// XLA (a cumsum and a backward lax.cummin, kmer_tpu/ops/devmerge.py:91-97)
// and so did this port's, in plain PyTorch (ops/kernels/merge_reduce.py
// merge_reduce_ref, which stays as the CPU twin).  On the card that tail
// was about a dozen launches over all R rows, and torch.cummin's scan with
// indices among them took ~1.4 of every ~1.5 s of device time at the k = 21
// benchmark cell.
//
// What bounds it: memory.  It reads each row's W key words and count once
// (8 (W + 1) R bytes) and writes the C-row state once (8 (W + 1) C bytes):
// at the k = 21 merge (W = 1, R ~ 25 M, C = 2^24) ~0.67 GB, 0.20 ms at
// 3.35 TB/s.
//
// Design: one pass, a segmented sum with decoupled look-back (Merrill and
// Garland, NVIDIA NVR-2016-002), as csrc/compact.cu (K4) compacts:
//   1. a block takes its tile id from an atomic counter (so every earlier
//      tile is resident or done and the look-back cannot deadlock; the
//      block that takes the last id resets it for the next call);
//   2. a thread owns ITEMS consecutive rows, loaded in 16-byte vectors a
//      plane; the row before its first and the row after its last come
//      from the neighbouring lanes by shuffles (lanes 0 and 31 load them),
//      so each row knows whether it starts a run (row 0, or any word
//      differs from the row before) and whether it ends one (row R - 1, or
//      the row after starts one); a run is real when its word 0 is not
//      SENTINEL (sentinel rows sort last);
//   3. the thread scans its rows' pairs (real runs started, sum since the
//      last start) under the segmented-sum operator
//      (a, s) + (b, t) = (a + b, b > 0 ? t : s + t), then the block scans
//      the threads' pairs (flag_scan.cuh block_exclusive_run_scan) and
//      publishes the tile's aggregate;
//   4. warp 0 looks back over a window of 32 status words at a time and
//      publishes the tile's inclusive prefix; the last tile writes the run
//      count, `distinct`;
//   5. a row that ends a real run writes its words and the run's total to
//      row (real runs started up to it) - 1 -- each output row once, in key
//      order -- staged a plane at a time in shared memory so that
//      consecutive threads store consecutive rows (rows past C are
//      dropped, as the twin drops them);
//   6. a second, small launch reads `distinct` on the device and writes
//      SENTINEL / 0 to rows [min(distinct, C), C) only.
// The tile status is wider than K4's one word (a 32-bit run count and an
// int64 sum besides the flag), so it is kept apart from the values, as
// CUB keeps a status wider than 8 bytes: a tile's slot of SLOT words holds
// its status word (flag << 32 | epoch), its aggregate and its inclusive
// prefix (runs, sum each).  A block writes a value with relaxed stores,
// then its status word with a release store; a reader loads the status
// word with an acquire load and only then the value its flag names.
// Aggregate and prefix have separate words, so the value a reader takes
// is never rewritten in the call; a 16-byte status would need a 128-bit
// single-copy-atomic store, which PTX does not promise for a vector
// store.  Each call passes a new epoch, so a status word left by an
// earlier call never matches and the scratch needs no reset between calls
// (the wrapper zeroes it when the epochs run out).  The slots do not move
// with a call's tile count, so a word read as a status word was only ever
// written as one: a value left where a status word is read could carry
// the epoch in its low bits.
// The body is chosen by W: W = 1 and W = 2 compiled with their words kept
// in registers; W >= 3 one general body that loops over the planes, passed
// in a by-value struct of 16 or MAX_PLANES pointers as csrc/sort.cu passes
// them, and loads a plane again (from L2) when it stages it.

#include <cstdint>
#include <cuda_runtime.h>

#include "flag_scan.cuh"

namespace {

using flag_scan::RunSum;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                      // rows a thread
constexpr int TILE = THREADS * ITEMS;         // 2048 rows a block
constexpr int WARPS = THREADS / 32;
constexpr int EPOCH_BITS = 32;
constexpr int MAX_PLANES = 240;
constexpr int PAD_THREADS = 256;
constexpr int PAD_BLOCKS = 1024;
constexpr int64_t SENTINEL = INT64_MAX;
constexpr uint64_t AGGREGATE = 1, PREFIX = 2;  // a status word's flag
static_assert(ITEMS % 2 == 0 && ITEMS < 32, "16-byte loads, a 32-bit mask");

template <int P> struct Planes {
  const int64_t* w[P];
};

// Scratch (int64 words): [0] the tile counter, then tile t's slot at
// 1 + SLOT t: its status word, its aggregate's (runs, sum) at +AGG and its
// inclusive prefix's at +INCL.
constexpr int SLOT = 5, AGG = 1, INCL = 3;

__host__ __device__ constexpr int64_t scratch_words_of(int64_t tiles) {
  return 1 + SLOT * tiles;
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int64_t load_relaxed(const int64_t* p) {
  int64_t v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int64_t* p, int64_t v) {
  asm volatile("st.relaxed.gpu.global.s64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// a tile's value (its aggregate or its inclusive prefix, by `flag`) in
// its slot, then its status word
__device__ __forceinline__ void publish(uint64_t* slot, RunSum v,
                                        uint64_t flag, uint32_t epoch) {
  int64_t* value = reinterpret_cast<int64_t*>(slot) +
                   (flag == PREFIX ? INCL : AGG);
  store_relaxed(value, v.runs);
  store_relaxed(value + 1, v.sum);
  store_release(slot, flag << EPOCH_BITS | epoch);
}

// The pair of every tile before `tile`, combined in tile order, by warp 0
// (all 32 lanes).  Lane i reads the status word at distance i below
// `pos`; the window is consumed from the nearest tile up to and including
// the nearest inclusive prefix, which ends the walk, or else up to the
// nearest tile whose word does not carry this call's epoch yet, where the
// next window starts.
__device__ RunSum look_back(const uint64_t* slots, int64_t tile,
                            uint32_t epoch) {
  const int lane = threadIdx.x % 32;
  RunSum before = {0, 0};
  for (int64_t pos = tile - 1;;) {
    const int64_t i = pos - lane;
    const uint64_t w =
        i >= 0 ? load_acquire(slots + SLOT * i) : PREFIX << EPOCH_BITS | epoch;
    const bool ready = (uint32_t)w == epoch;
    const bool prefix = ready && (w >> EPOCH_BITS) == PREFIX;
    const unsigned waits = __ballot_sync(flag_scan::FULL, !ready);
    const unsigned prefixes = __ballot_sync(flag_scan::FULL, prefix);
    const int dw = waits ? __ffs(waits) - 1 : 32;
    const int dp = prefixes ? __ffs(prefixes) - 1 : 32;
    const bool done = dp < dw;
    const int stop = done ? dp + 1 : dw;     // lanes [0, stop) are taken
    RunSum v = {0, 0};
    if (lane < stop && i >= 0) {
      const int64_t* src = reinterpret_cast<const int64_t*>(slots) +
                           SLOT * i + (prefix ? INCL : AGG);
      v = {(int)load_relaxed(src), load_relaxed(src + 1)};
    }
    before = flag_scan::run_combine(flag_scan::warp_run_total_reversed(v),
                                    before);
    if (done) return before;
    pos -= stop;
  }
}

// rows [first, first + ITEMS) of plane p (`fill` past n)
__device__ __forceinline__ void load_rows(const int64_t* __restrict__ p,
                                          int64_t first, int64_t n,
                                          int64_t fill,
                                          int64_t (&v)[ITEMS]) {
  if (first + ITEMS <= n) {
#pragma unroll
    for (int h = 0; h < ITEMS / 2; ++h) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p + first)
                                + h);
      v[2 * h] = x.x;
      v[2 * h + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      v[j] = first + j < n ? __ldg(p + first + j) : fill;
  }
}

// bit j (0 <= j <= ITEMS): row first + j differs in plane p from row
// first + j - 1; the rows just outside the thread's come from the lanes
// beside it, or from memory at the warp's edges
__device__ __forceinline__ unsigned neighbour_diff(
    const int64_t* __restrict__ p, const int64_t (&x)[ITEMS], int64_t first,
    int64_t n) {
  const int lane = threadIdx.x % 32;
  int64_t prev = __shfl_up_sync(flag_scan::FULL, x[ITEMS - 1], 1);
  int64_t next = __shfl_down_sync(flag_scan::FULL, x[0], 1);
  if (lane == 0) prev = first > 0 && first <= n ? __ldg(p + first - 1) : x[0];
  if (lane == 31)
    next = first + ITEMS < n ? __ldg(p + first + ITEMS) : x[ITEMS - 1];
  unsigned d = (unsigned)(x[0] != prev);
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) d |= (unsigned)(x[j] != x[j - 1]) << j;
  return d | (unsigned)(next != x[ITEMS - 1]) << ITEMS;
}

// One output plane of the block: x at the thread's ending rows (bits of
// `fin`), staged from slot `slot0` in row order, then rows [base, base +
// n_out) of dst (those below C) stored from consecutive threads.  Called by
// every thread of the block.
__device__ __forceinline__ void write_plane(const int64_t (&x)[ITEMS],
                                            unsigned fin, int slot0,
                                            int n_out, int64_t* staged,
                                            int64_t* __restrict__ dst,
                                            int64_t base, int64_t C) {
  int s = slot0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if ((fin >> j) & 1u) staged[s++] = x[j];
  __syncthreads();
  for (int r = threadIdx.x; r < n_out && base + r < C; r += THREADS)
    dst[base + r] = staged[r];
  __syncthreads();
}

// NW > 0: W = NW planes, kept in registers; NW = 0: nw planes (3 to P),
// loaded again when staged.  out: (nw + 1) x C int64, plane q at q C, the
// totals last.
template <int NW, int P>
__global__ void __launch_bounds__(THREADS)
merge_reduce_kernel(Planes<P> keys, int nw,
                    const int64_t* __restrict__ counts, int64_t R, int64_t C,
                    int64_t tiles, uint64_t* __restrict__ scratch,
                    uint32_t epoch, int64_t* __restrict__ out,
                    int64_t* __restrict__ distinct) {
  __shared__ int64_t staged[TILE];
  __shared__ RunSum warp_runs[WARPS];
  __shared__ int warp_ends[WARPS];
  __shared__ int64_t tile_s, base_s;
  __shared__ RunSum before_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = NW > 0 ? NW : nw;
  uint64_t* slots = scratch + 1;

  if (threadIdx.x == 0) {
    const uint64_t t =
        atomicAdd(reinterpret_cast<unsigned long long*>(scratch), 1ull);
    // every block of this call has taken its id: reset for the next call
    if ((int64_t)t == tiles - 1)
      atomicExch(reinterpret_cast<unsigned long long*>(scratch), 0ull);
    tile_s = (int64_t)t;
  }
  __syncthreads();
  const int64_t tile = tile_s;
  const int64_t first = tile * TILE + (int64_t)threadIdx.x * ITEMS;

  int64_t c[ITEMS];
  load_rows(counts, first, R, 0, c);
  int64_t v[NW > 0 ? NW : 1][ITEMS];
  unsigned diff = 0, live = 0;
  if constexpr (NW > 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      load_rows(keys.w[q], first, R, SENTINEL, v[q]);
      diff |= neighbour_diff(keys.w[q], v[q], first, R);
    }
  } else {
    for (int q = 0; q < W; ++q) {
      load_rows(keys.w[q], first, R, SENTINEL, v[0]);
      diff |= neighbour_diff(keys.w[q], v[0], first, R);
      if (q == 0) {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
          live |= (unsigned)(v[0][j] != SENTINEL) << j;
      }
    }
  }
  if constexpr (NW > 0) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      live |= (unsigned)(v[0][j] != SENTINEL) << j;
  }
  // rows past R are not live (their word 0 is the fill)
  unsigned starts = diff & ((1u << ITEMS) - 1), ends = diff >> 1;
  if (first == 0) starts |= 1u;
  if (first < R && R - first <= ITEMS) ends |= 1u << (R - 1 - first);
  const unsigned flag = starts & live, fin = ends & live;

  RunSum mine = {0, 0};
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    mine = (flag >> j) & 1u ? RunSum{mine.runs + 1, c[j]}
                            : RunSum{mine.runs, mine.sum + c[j]};
  RunSum agg;
  const RunSum below =
      flag_scan::block_exclusive_run_scan<WARPS>(mine, warp_runs, agg);
  int n_out;
  const int slot0 =
      flag_scan::block_exclusive_scan<WARPS>(__popc(fin), warp_ends, n_out);
  if (threadIdx.x == 0) {
    publish(slots + SLOT * tile, agg, tile == 0 ? PREFIX : AGGREGATE, epoch);
  }

  if (warp == 0) {
    RunSum before = {0, 0};
    if (tile > 0) {
      before = look_back(slots, tile, epoch);
      if (lane == 0)
        publish(slots + SLOT * tile, flag_scan::run_combine(before, agg),
                PREFIX, epoch);
    }
    if (lane == 0) {
      before_s = before;
      // the tile's first output row: the run open at its first row ends
      // in it (that row is real and starts nothing), else the next run
      base_s = before.runs - ((live & ~flag) & 1u);
      if (tile == tiles - 1)
        *distinct = flag_scan::run_combine(before, agg).runs;
    }
  }
  __syncthreads();

  // each ending row's run total, in place of its count
  RunSum run = flag_scan::run_combine(before_s, below);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    run = (flag >> j) & 1u ? RunSum{run.runs + 1, c[j]}
                           : RunSum{run.runs, run.sum + c[j]};
    c[j] = run.sum;
  }

  // each plane, then the totals
  const int64_t base = base_s;
  if constexpr (NW > 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q)
      write_plane(v[q], fin, slot0, n_out, staged, out + q * C, base, C);
  } else {
    for (int q = 0; q < W; ++q) {
      if (fin) load_rows(keys.w[q], first, R, SENTINEL, v[0]);
      write_plane(v[0], fin, slot0, n_out, staged, out + (int64_t)q * C, base,
                  C);
    }
  }
  write_plane(c, fin, slot0, n_out, staged, out + (int64_t)W * C, base, C);
}

// rows [min(distinct, C), C): SENTINEL key words, count 0
__global__ void __launch_bounds__(PAD_THREADS)
pad_kernel(int64_t* __restrict__ out, int nw, int64_t C,
           const int64_t* __restrict__ distinct) {
  const int64_t d = *distinct < C ? *distinct : C;
  const int64_t stride = (int64_t)gridDim.x * PAD_THREADS;
  for (int64_t r = d + (int64_t)blockIdx.x * PAD_THREADS + threadIdx.x;
       r < C; r += stride) {
    for (int q = 0; q < nw; ++q) out[(int64_t)q * C + r] = SENTINEL;
    out[(int64_t)nw * C + r] = 0;
  }
}

template <int NW, int P>
int reduce_rows(const int64_t* const* keys, int nw, const int64_t* counts,
                int64_t R, int64_t C, uint64_t* scratch, uint32_t epoch,
                int64_t* out, int64_t* distinct, cudaStream_t st) {
  Planes<P> kp = {};
  for (int q = 0; q < nw; ++q) kp.w[q] = keys[q];
  const int64_t tiles = (R + TILE - 1) / TILE;
  merge_reduce_kernel<NW, P><<<(unsigned)tiles, THREADS, 0, st>>>(
      kp, nw, counts, R, C, tiles, scratch, epoch, out, distinct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 0) return (int)err;
  const int64_t blocks = (C + PAD_THREADS - 1) / PAD_THREADS;
  pad_kernel<<<(unsigned)(blocks < PAD_BLOCKS ? blocks : PAD_BLOCKS),
               PAD_THREADS, 0, st>>>(out, nw, C, distinct);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout the wrapper checks at load: rows a tile, and the bits of a
// status word's epoch.
extern "C" void merge_reduce_layout(int32_t* out) {
  out[0] = TILE;
  out[1] = EPOCH_BITS;
}

// int64 words of scratch a call over R rows needs.
extern "C" int64_t merge_reduce_scratch_words(int64_t R) {
  return scratch_words_of((R + TILE - 1) / TILE);
}

// keys: nw host pointers to R int64 rows each, sorted (with counts) by the
// nw words; counts: R int64; both 16-byte aligned.  scratch:
// merge_reduce_scratch_words(R) uint64, zero when allocated, used by one
// stream at a time; epoch in [1, 2^32), a new one each call since the
// scratch was last zeroed.  out: (nw + 1) C int64 (the C-row state's
// planes, then its counts); distinct: one int64.  1 <= nw <= MAX_PLANES,
// 1 <= R < 2^31, 0 <= C <= R.  Returns the first failing launch's
// cudaError_t, or 0; never synchronises.
extern "C" int merge_reduce_launch(const int64_t* const* keys, int nw,
                                   const int64_t* counts, int64_t R,
                                   int64_t C, uint64_t* scratch,
                                   uint32_t epoch, int64_t* out,
                                   int64_t* distinct, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (keys == nullptr || nw < 1 || nw > MAX_PLANES || R < 1 ||
      R >= ((int64_t)1 << 31) || C < 0 || C > R || epoch == 0 ||
      counts == nullptr || misaligned(counts) || scratch == nullptr ||
      (out == nullptr && C > 0) || distinct == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < nw; ++q)
    if (keys[q] == nullptr || misaligned(keys[q]))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1: return reduce_rows<1, 1>(keys, nw, counts, R, C, scratch, epoch,
                                     out, distinct, st);
    case 2: return reduce_rows<2, 2>(keys, nw, counts, R, C, scratch, epoch,
                                     out, distinct, st);
    default:
      return nw <= 16 ? reduce_rows<0, 16>(keys, nw, counts, R, C, scratch,
                                           epoch, out, distinct, st)
                      : reduce_rows<0, MAX_PLANES>(keys, nw, counts, R, C,
                                                   scratch, epoch, out,
                                                   distinct, st);
  }
}
