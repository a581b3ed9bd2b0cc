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
// single-pass stream compaction with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA technical report NVR-2016-002), one launch a call:
//   1. a block takes its tile id from an atomic counter, not from
//      blockIdx, so every earlier tile has a block that is resident or
//      done and the look-back cannot deadlock; the block that takes the
//      last id puts the counter back to 0 for the next call;
//   2. a thread owns ITEMS consecutive lanes for their counts, loaded in
//      16-byte vectors (16 int8 lanes a load, or 4 int32 lanes); one pass
//      over the per-warp totals in shared memory (flag_scan.cuh
//      block_exclusive_scan) gives each thread's first record and the
//      tile's aggregate, which the block publishes in the tile's status
//      word at once, before its keys are loaded;
//   3. the keys are loaded warp-striped (round j of warp w reads lane
//      512 w + 32 j + lane, so a warp's load is 256 contiguous bytes), each
//      lane's live bit taken from its count's owner by one shuffle and its
//      rank by a ballot (flag_scan.cuh ballot_rank); all of a thread's
//      live keys are in flight before any wait below;
//   4. warp 0 looks back (look_back: a window of 32 LOOK status words, all
//      loads in flight at once, consumed from the nearest up to the
//      nearest inclusive prefix, or up to the nearest word not out yet,
//      where the next window starts) and publishes the tile's inclusive
//      prefix, while the other warps stage their records in shared
//      memory in lane order (keys by the loader, counts by their owner,
//      at a skewed slot that keeps the owners' stores free of bank
//      conflicts);
//   5. the block writes its staged records out so that consecutive
//      threads write consecutive records: 16-byte stores of two keys and
//      of two counts from the first even output row (a pair's key as one
//      16-byte store); the last tile writes the total.
// Registers decide the blocks an SM: about 100 a thread for one key plane
// and 128 for a pair, so 5 and 4 blocks of 128 threads, and K1's 560
// tiles of 2048 lanes run in one wave on 132 SMs.  Tiles of 256 or 512
// threads, capping registers for more blocks (spills), a look-back window
// of 4 words a lane and prefetching the tile named by blockIdx measured
// slower (PERF.md §6).
// A status word is flag (2 bits: aggregate or inclusive prefix) | epoch
// (EPOCH_BITS) | value (VALUE_BITS).  The wrapper passes a new epoch each
// call, so a word left over from an earlier call never matches, and the
// status words need no reset between calls (and no host sync); when the
// epochs run out the wrapper zeroes the scratch on the stream and starts
// again at 1 (0 is never a call's epoch).  The single 64-bit word carries
// its flag and its value together, so a reader needs no fence between
// them.
// The output is the stable compaction of the lane stream.  Records are
// written in the layout the host aggregation takes
// (pipeline/table.reduce_fused): a k <= 31 key as it is; a pair (hi, lo)
// -- gapped, or a key of 32 to 63 bases -- as its value hi * 4^r_len +
// lo, one uint64 when it fits 63 bits, else the two uint64 halves [vhi,
// vlo]; at r_len = 32 (s = 64) those are hi and lo with its stored top-bit
// flip taken off.  Keys of three or four int64 words (64 to 125 bases in
// the general layout of ops/encode, or a gapped key past 31-base windows;
// compact mode caps keys at 111 bases) are written as their words, which
// the host converts (pipeline/table.planes_to_fused).  Counts widen to
// int64.

#include <cstdint>
#include <cuda_runtime.h>

#include "flag_scan.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ITEMS = 16;                     // lanes a thread, a round
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_LANES = 32 * ITEMS;        // a warp's lanes of a tile
constexpr int LOOK = 1;                       // status words a lane reads
constexpr int EPOCH_BITS = 22;
constexpr int VALUE_BITS = 40;
constexpr uint64_t VALUE_MASK = (1ull << VALUE_BITS) - 1;
constexpr uint64_t EPOCH_MASK = (1ull << EPOCH_BITS) - 1;
constexpr uint64_t AGGREGATE = 1, PREFIX = 2;  // a status word's flag
// shared slots of the staged counts: q + q / 32, so that owner t's
// stores of records 16 t + j hit 32 banks
constexpr int COUNT_SLOTS = TILE + TILE / 32;
static_assert(ITEMS == 16, "a warp's round reads 32 lanes of 16 owners");

__device__ __forceinline__ int count_slot(int q) { return q + (q >> 5); }

__device__ __forceinline__ uint64_t status_word(uint64_t flag, uint32_t epoch,
                                                int64_t value) {
  return flag << 62 | (uint64_t)epoch << VALUE_BITS | (uint64_t)value;
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The records of every tile before `tile`, by warp 0 (all 32 lanes).  A
// window is the 32 LOOK status words nearest below `pos`, all loads in
// flight at once, lane i holding those at distance LOOK i + k.  Its words
// are consumed from the nearest: up to and including the nearest
// inclusive prefix, which ends the walk, or else up to the nearest word
// that does not carry this call's epoch yet, where the next window starts.
__device__ int64_t look_back(const uint64_t* status, int64_t tile,
                             uint32_t epoch) {
  const int lane = threadIdx.x % 32;
  int64_t before = 0;
  for (int64_t pos = tile - 1;;) {
    uint64_t w[LOOK];
    int wait = LOOK, prefix = LOOK;            // this lane's nearest of each
#pragma unroll
    for (int k = LOOK - 1; k >= 0; --k) {
      const int64_t i = pos - (int64_t)lane * LOOK - k;
      w[k] = i >= 0 ? load_status(status + i) : status_word(PREFIX, epoch, 0);
      if (((w[k] >> VALUE_BITS) & EPOCH_MASK) != epoch)
        wait = k;
      else if ((w[k] >> 62) == PREFIX)
        prefix = k;
    }
    // the window's nearest waiting word and nearest prefix (32 LOOK: none)
    const unsigned waits = __ballot_sync(flag_scan::FULL, wait < LOOK);
    const unsigned prefixes = __ballot_sync(flag_scan::FULL, prefix < LOOK);
    const int lw = waits ? __ffs(waits) - 1 : 0;
    const int lp = prefixes ? __ffs(prefixes) - 1 : 0;
    const int dw = __shfl_sync(flag_scan::FULL, wait, lw) + lw * LOOK;
    const int dp = __shfl_sync(flag_scan::FULL, prefix, lp) + lp * LOOK;
    const bool done = prefixes && (!waits || dp < dw);
    const int stop = done ? dp + 1 : waits ? dw : 32 * LOOK;
    int64_t sum = 0;
#pragma unroll
    for (int k = 0; k < LOOK; ++k)
      if (lane * LOOK + k < stop) sum += (int64_t)(w[k] & VALUE_MASK);
    before += flag_scan::warp_sum(sum);
    if (done) return before;
    pos -= stop;
  }
}

// the ITEMS counts of the lanes [first, first + ITEMS) (0 past n)
template <typename C>
__device__ __forceinline__ void load_counts(const C* __restrict__ counts,
                                            int64_t first, int64_t n,
                                            C (&c)[ITEMS]) {
  constexpr int PER_LOAD = 16 / sizeof(C);
  if (first + ITEMS <= n) {
#pragma unroll
    for (int v = 0; v < ITEMS / PER_LOAD; ++v) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(counts + first) + v);
      const C* e = reinterpret_cast<const C*>(&x);
#pragma unroll
      for (int j = 0; j < PER_LOAD; ++j) c[v * PER_LOAD + j] = e[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      c[j] = first + j < n ? __ldg(counts + first + j) : (C)0;
  }
}

// the key planes, by value
constexpr int MAX_PLANES = 4;
struct KeyPlanes {
  const int64_t* w[MAX_PLANES];
};

// MODE 0: one int64 key plane, written as it is;
// MODE 1: a pair (hi, lo) written as the one-word value (hi << s) | lo;
// MODE 2: a pair written as [hi >> (64 - s), (hi << s) | lo], or
//         [hi, lo ^ 2^63] at s = 64;
// MODE 3: NW = 3 or 4 planes written as they are.
// scratch[0] is the tile counter, scratch[1 + t] tile t's status word.
template <int MODE> __host__ __device__ constexpr int planes_of(int nw) {
  return MODE == 0 ? 1 : MODE == 3 ? nw : 2;
}
template <int MODE> __host__ __device__ constexpr int record_words(int nw) {
  return MODE <= 1 ? 1 : MODE == 2 ? 2 : nw;
}

template <typename C, int MODE, int NW>
__global__ void __launch_bounds__(THREADS)
compact_kernel(KeyPlanes keys, const C* __restrict__ counts, int64_t n,
               int64_t tiles, uint64_t* __restrict__ scratch, uint32_t epoch,
               int s, int64_t* __restrict__ out_keys,
               int64_t* __restrict__ out_counts, int64_t* __restrict__ total) {
  constexpr int P = planes_of<MODE>(NW), R = record_words<MODE>(NW);
  // staged records: R key planes, then the counts
  extern __shared__ __align__(16) int64_t staged[];
  int64_t* skey0 = staged;
  int64_t* skey1 = staged + TILE;
  int32_t* scount = reinterpret_cast<int32_t*>(staged + R * TILE);
  __shared__ int warp_tot[WARPS];
  __shared__ int64_t tile_s, base_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint64_t* status = scratch + 1;

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
  const int64_t wfirst = tile * TILE + (int64_t)warp * WARP_LANES;

  // counts: lanes [16 lane, 16 lane + 16) of the warp's lanes
  C c[ITEMS];
  load_counts<C>(counts, wfirst + lane * ITEMS, n, c);
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) live |= (unsigned)(c[j] > 0) << j;
  const int mine = __popc(live);

  // the block's aggregate, published before the keys are loaded
  int agg;
  const int below = flag_scan::block_exclusive_scan<WARPS>(mine, warp_tot,
                                                           agg);
  if (threadIdx.x == 0)
    store_status(status + tile,
                 status_word(tile == 0 ? PREFIX : AGGREGATE, epoch, agg));

  // keys, warp-striped: round j reads warp lane 32 j + lane, whose count
  // thread 2 j + lane / 16 owns as its bit lane % 16; its rank in the warp
  // is the live lanes of the rounds before and those below it in this one
  const int bit = lane & 15;
  int rank[ITEMS];                  // rank in the warp, or -1 if dead
  int64_t k[P][ITEMS];
  int in_rounds = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned o = __shfl_sync(flag_scan::FULL, live, 2 * j + (lane >> 4));
    const bool on = (o >> bit) & 1u;
    unsigned round;
    const int r = flag_scan::ballot_rank(on, round);
    rank[j] = on ? in_rounds + r : -1;
    in_rounds += __popc(round);
    const int64_t i = wfirst + 32 * j + lane;
    if (on) {
#pragma unroll
      for (int q = 0; q < P; ++q) k[q][j] = __ldg(keys.w[q] + i);
    }
  }

  // warp 0 looks back while its keys and the other warps' are in flight
  const int wbase = __shfl_sync(flag_scan::FULL, below, 0);
  if (warp == 0) {
    int64_t before = 0;
    if (tile > 0) {
      before = look_back(status, tile, epoch);
      if (lane == 0)
        store_status(status + tile,
                     status_word(PREFIX, epoch, before + agg));
    }
    if (lane == 0) {
      base_s = before;
      if (tile == tiles - 1) *total = before + agg;
    }
  }

  // stage: counts by their owner, keys by their loader
  int q = below;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if ((live >> j) & 1u) scount[count_slot(q++)] = (int32_t)c[j];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (rank[j] < 0) continue;
    const int r = wbase + rank[j];
    if constexpr (MODE == 0) {
      skey0[r] = k[0][j];
    } else if constexpr (MODE == 3) {
#pragma unroll
      for (int q = 0; q < P; ++q) staged[q * TILE + r] = k[q][j];
    } else {
      const uint64_t hi = (uint64_t)k[0][j], lo = (uint64_t)k[1][j];
      if constexpr (MODE == 1) {
        skey0[r] = (int64_t)((hi << s) | lo);
      } else if (s == 64) {
        skey0[r] = (int64_t)hi;
        skey1[r] = (int64_t)(lo ^ (1ull << 63));
      } else {
        skey0[r] = (int64_t)(hi >> (64 - s));
        skey1[r] = (int64_t)((hi << s) | lo);
      }
    }
  }
  __syncthreads();

  // write out rows [base, base + agg), consecutive threads on consecutive
  // rows
  const int64_t base = base_s;
  if constexpr (MODE == 3) {
    // word e of the block's records, consecutive threads on consecutive
    // words
    for (int e = threadIdx.x; e < agg * R; e += THREADS)
      out_keys[base * R + e] = staged[(e % R) * TILE + e / R];
    for (int r = threadIdx.x; r < agg; r += THREADS)
      out_counts[base + r] = scount[count_slot(r)];
    return;
  }
  if constexpr (MODE == 2) {
    for (int r = threadIdx.x; r < agg; r += THREADS) {
      reinterpret_cast<longlong2*>(out_keys)[base + r] =
          make_longlong2(skey0[r], skey1[r]);
      out_counts[base + r] = scount[count_slot(r)];
    }
    return;
  }
  // pairs of rows from the first even output row: pair p holds local rows
  // 2 p - odd and 2 p - odd + 1
  const int odd = (int)(base & 1);
  for (int p = threadIdx.x; 2 * p < agg + odd; p += THREADS) {
    const int r = 2 * p - odd;
    if (r >= 0 && r + 1 < agg) {
      reinterpret_cast<longlong2*>(out_keys + base + r)[0] =
          make_longlong2(skey0[r], skey0[r + 1]);
      reinterpret_cast<longlong2*>(out_counts + base + r)[0] =
          make_longlong2(scount[count_slot(r)], scount[count_slot(r + 1)]);
    } else {
      const int r1 = r >= 0 ? r : r + 1;     // the one row of the pair
      if (r1 < agg) {
        out_keys[base + r1] = skey0[r1];
        out_counts[base + r1] = scount[count_slot(r1)];
      }
    }
  }
}

template <typename C, int MODE, int NW>
int compact_rows(const KeyPlanes& keys, const C* counts, int64_t n,
                 uint64_t* scratch, uint32_t epoch, int s, int64_t* out_keys,
                 int64_t* out_counts, int64_t* total, cudaStream_t st) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  const size_t smem = (size_t)record_words<MODE>(NW) * TILE * sizeof(int64_t) +
                      COUNT_SLOTS * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      compact_kernel<C, MODE, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  compact_kernel<C, MODE, NW><<<(unsigned)tiles, THREADS, smem, st>>>(
      keys, counts, n, tiles, scratch, epoch, s, out_keys, out_counts, total);
  return (int)cudaGetLastError();
}

template <typename C>
int compact_mode(const KeyPlanes& keys, int nw, const C* counts, int64_t n,
                 uint64_t* scratch, uint32_t epoch, int mode, int s,
                 int64_t* out_keys, int64_t* out_counts, int64_t* total,
                 cudaStream_t st) {
  switch (mode) {
    case 0: return compact_rows<C, 0, 1>(keys, counts, n, scratch, epoch, s,
                                         out_keys, out_counts, total, st);
    case 1: return compact_rows<C, 1, 2>(keys, counts, n, scratch, epoch, s,
                                         out_keys, out_counts, total, st);
    case 2: return compact_rows<C, 2, 2>(keys, counts, n, scratch, epoch, s,
                                         out_keys, out_counts, total, st);
    default:
      if (nw == 3)
        return compact_rows<C, 3, 3>(keys, counts, n, scratch, epoch, s,
                                     out_keys, out_counts, total, st);
      return compact_rows<C, 3, 4>(keys, counts, n, scratch, epoch, s,
                                   out_keys, out_counts, total, st);
  }
}

}  // namespace

// The layout the wrapper sizes its scratch by: lanes a tile, and the bits
// of a status word's epoch.
extern "C" void compact_layout(int32_t* out) {
  static_assert(TILE == 2048, "ops/kernels/compact.py sizes the scratch");
  out[0] = TILE;
  out[1] = EPOCH_BITS;
}

// keys: nw host pointers to n int64 lanes each (nw = 1 in mode 0, 2 in
// modes 1 and 2, 3 or 4 in mode 3); counts: n int8 (count_bytes 1) or
// int32 (count_bytes 4), 16-byte aligned; scratch: 1 + ceil(n / TILE)
// uint64, zero when allocated, counter first, then the status words, used
// by one stream at a time; epoch in [1, 2^EPOCH_BITS), a new one each call
// since the scratch was last zeroed; out_keys: n (modes 0, 1), 2n (mode 2)
// or nw n (mode 3) int64, out_counts: n int64, both 16-byte aligned; total:
// one int64.  s = 2 * r_len in [2, 62] for mode 1, [2, 64] for mode 2.
// Returns the launch's cudaError_t, or 0.
extern "C" int compact_launch(const int64_t* const* keys, int nw,
                              const void* counts, int count_bytes, int64_t n,
                              uint64_t* scratch, uint32_t epoch, int mode,
                              int s, int64_t* out_keys, int64_t* out_counts,
                              int64_t* total, void* stream) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const int want = mode == 0 ? 1 : mode == 3 ? nw : 2;
  if (n < 1 || n >= (int64_t)1 << VALUE_BITS || tiles > 0x7FFFFFFF ||
      mode < 0 || mode > 3 || nw != want || nw < 1 || nw > MAX_PLANES ||
      (mode == 3 && nw < 3) || (count_bytes != 1 && count_bytes != 4) ||
      ((mode == 1 || mode == 2) &&
       (s < 2 || s > (mode == 2 ? 64 : 62))) ||
      epoch == 0 || epoch > EPOCH_MASK || misaligned(counts) ||
      misaligned(out_keys) || misaligned(out_counts))
    return (int)cudaErrorInvalidValue;
  KeyPlanes kp = {};
  for (int q = 0; q < nw; ++q) {
    if (keys[q] == nullptr) return (int)cudaErrorInvalidValue;
    kp.w[q] = keys[q];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 1)
    return compact_mode<int8_t>(kp, nw, static_cast<const int8_t*>(counts),
                                n, scratch, epoch, mode, s, out_keys,
                                out_counts, total, st);
  return compact_mode<int32_t>(kp, nw, static_cast<const int32_t*>(counts),
                               n, scratch, epoch, mode, s, out_keys,
                               out_counts, total, st);
}
