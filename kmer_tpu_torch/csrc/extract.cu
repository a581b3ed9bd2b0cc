// Row-layout k-mer extraction for Hopper (sm_90a): the key of every window
// start of every row, canonical on request, SENTINEL on invalid lanes, with
// no collapse.  It feeds the unfused count step (the grouped counts of
// csrc/grouped_count.cu, or the flat sort of csrc/sort.cu).
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/extract.py `_extract_kernel`
// (pallas_call at :88, entry extract_repacked :65).
//
// What bounds it: memory, and there the key stores.  Each output lane is
// one 8-byte key store (16 for a (hi, lo) pair, 8 W for W words); the
// input is L/4 bytes of packed codes a row (L bytes for u8 rows) and two
// int32 a row; the arithmetic is a few integer operations a key word.
//
// Design: the TPU kernel builds every window of a row block at once from k
// shifted slices and splits the key into the (top, bot) uint32 words of its
// sort layout, so it takes only 17 <= k <= 31 and no ambiguous codes
// (kmer_tpu's unfused route extracts every other key outside a kernel).
// Here a key is one int64, an int64 (hi, lo) pair or W int64 words, so
// every k, spaced seeds and the ambiguity mask come at no cost.  The bodies
// (kmer_window.cuh holds what they share with csrc/fused_extract.cu):
// - extract_cut_kernel, a contiguous key: a block takes a tile of
//   consecutive outputs of the flat (B, P) row-major output, `iters` a
//   thread, and thread i takes flat index f0 + i of each round, so a
//   warp's stores are contiguous whatever P is, straight from registers.
//   The block stages the rows the tile touches, each over the windows it
//   takes (CutTile: packed words and, with the ambiguity mask, ambiguity
//   words) with each row's last valid window, and cuts each key out of
//   shared memory with a few funnel shifts, its reverse complement with a
//   bit reverse, and no priming.  `iters` is chosen so that the grid holds
//   about as many threads as the card has slots;
// - extract_rolled_kernel, a spaced seed of span <= 64: one thread walks a
//   chunk of 32 windows of one row, rolls the whole span (SpanWalk),
//   primed with span - 1 bases, and cuts the keys of 4 windows at a time
//   out of the registers by the seed's cut table, with a rolled bit a base
//   for ambiguity;
// - extract_gather_kernel, a spaced seed of span over 64: one thread walks
//   a chunk of 16 windows of one row and gathers each key's bases;
// - extract_wide_tile_kernel, a contiguous key of more than 63 bases in W
//   int64 words (ops/encode's general layout), on the cut body's plan: a
//   block takes a tile of consecutive flat outputs, stages the rows they
//   touch once (CutTile) with each row's last valid window, finds each
//   thread's first (row, window) by one 32-bit division and the next ones
//   by steps of CUT_THREADS outputs, cuts each 31-base word and its
//   reverse complement out of shared memory, and stores plane by plane,
//   neighbouring threads on neighbouring addresses; the canonical key
//   compares the two strands word by word first and cuts the chosen
//   one's words second, one cut a word chosen by selects, so no word is
//   held.  Rows so wide that one output a thread would outgrow the
//   block's shared memory take extract_wide_kernel, the same key with
//   each word cut straight from the row in device memory (GlobalRow:
//   three words and a few funnel shifts a cut), one thread a lane;
// - extract_gapped_kernel, the gapped L+R lanes of the unfused route: one
//   thread a lane, each window cut straight from the row in device memory,
//   with no staging and no cap on the row's width.
// The rolled and gathered bodies stage their keys in shared memory (one
// plane a key word) and store the block's contiguous range of the output
// with neighbouring threads on neighbouring addresses; thread t of the
// grid takes chunk t of the flat output, row-major, and the staging index
// skips one slot every chunk, so the 16 threads of a half-warp that write
// key j of their chunks fall in different banks.  The rolled body takes
// blocks of 64 threads, so that its staging stays 33.8 KB, under the 48 KB
// of static shared memory.

#include <cstdint>
#include <cuda_runtime.h>
#include <algorithm>
#include <utility>

#include "kmer_window.cuh"

namespace {

// the gathered body's window starts a thread and threads a block
constexpr int CHUNK = 16;
constexpr int THREADS = 128;
constexpr int STAGE = THREADS * CHUNK + THREADS;   // keys + one pad slot a chunk
static_assert(CHUNK % 16 == 0, "a chunk starts on a packed word");
// the rolled body's chunk and block
constexpr int ROLLED_CHUNK = 32, ROLLED_THREADS = 64;
constexpr int ROLLED_STAGE = ROLLED_THREADS * ROLLED_CHUNK + ROLLED_THREADS;
static_assert(ROLLED_CHUNK % 16 == 0, "a chunk starts on a packed word");

// the cut body's threads a block, most keys a thread, and shared bytes
constexpr int CUT_THREADS = 256, MAX_ITERS = 8, CUT_SMEM = 48 * 1024;

template <int C>
__device__ __forceinline__ int stage_slot(int64_t i) {
  return (int)(i + i / C);
}

// a contiguous key cut out of the block's tile
template <typename KEY, bool PACKED, bool CANON>
__global__ void __launch_bounds__(CUT_THREADS)
extract_cut_kernel(const void* __restrict__ codes, int row_stride,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ limits,
                   int64_t* __restrict__ keys_hi,
                   int64_t* __restrict__ keys_lo, int B, int L, int n, int P,
                   int mask_amb, int iters, int cap, int stride) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  extern __shared__ uint32_t tile_sm[];
  const int64_t total = (int64_t)B * P;
  const int64_t f0 = (int64_t)blockIdx.x * CUT_THREADS * iters;
  const int64_t f_end = f0 + (int64_t)CUT_THREADS * iters;
  const int64_t f1 = f_end < total ? f_end : total;
  // the tile's rows b0 .. and its outputs [l0, l1) counted from row b0's
  // first; slot s serves row b0 + s over windows [l0 - s P, l1 - s P) in
  // [0, P)
  const int b0 = (int)(f0 / P);
  const int64_t base = (int64_t)b0 * P;
  const int l0 = (int)(f0 - base), l1 = (int)(f1 - base);
  auto first = [=](int s) { return max(l0 - s * P, 0); };
  const kmer::CutTile tile = {tile_sm, cap, stride, n, (L + 15) / 16,
                              !PACKED && mask_amb != 0};
  // window o of slot s is valid iff o < o_hi[s] (o <= len - n, o <
  // limit) and no base of it is ambiguous; a slot a row, at most one an
  // output (P = 1)
  __shared__ int o_hi[CUT_THREADS * MAX_ITERS];
  const int slots = (l1 - 1) / P + 1;
  for (int s = threadIdx.x; s < slots; s += CUT_THREADS)
    o_hi[s] = min(lengths[b0 + s] - n + 1, limits[b0 + s]);
  tile.stage<PACKED>(codes, row_stride, L, b0, slots, first);
  for (int i = l0 + threadIdx.x; i < l1; i += CUT_THREADS) {
    const int s = i / P, o = i - s * P;
    const int wa = first(s);
    bool ok = o < o_hi[s];
    int64_t hi, lo;
    tile.key<TWO, CANON>(s, o, wa, hi, lo);
    if (!PACKED && mask_amb) ok = ok && !tile.ambiguous<TWO>(s, o, wa);
    if (!ok) hi = lo = kmer::SENTINEL;
    keys_hi[base + i] = hi;
    if constexpr (TWO) keys_lo[base + i] = lo;
  }
}

// a spaced seed of span over 64: the gathered key
template <typename KEY, bool PACKED, bool CANON>
__global__ void __launch_bounds__(THREADS)
extract_gather_kernel(const void* __restrict__ codes, int row_stride,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ limits,
                      int64_t* __restrict__ keys_hi,
                      int64_t* __restrict__ keys_lo, int B, int L, int n,
                      int span, int P, int cpr, int mask_amb,
                      kmer::Offsets off) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  __shared__ int64_t stage[TWO ? 2 : 1][STAGE];
  __shared__ int16_t pos[kmer::MAX_BASES];
  if (threadIdx.x < n) pos[threadIdx.x] = off.at[threadIdx.x];
  __syncthreads();
  const int64_t n_chunks = (int64_t)B * cpr;
  const int64_t c0 = (int64_t)blockIdx.x * THREADS;
  const int64_t c_end = c0 + THREADS < n_chunks ? c0 + THREADS : n_chunks;
  // flat output index of the first key of chunk c
  auto first_of = [&](int64_t c) -> int64_t {
    const int64_t b = c / cpr;
    return b * P + (c - b * cpr) * CHUNK;
  };
  const int64_t f0 = first_of(c0);
  const int64_t f1 = c_end == n_chunks ? (int64_t)B * P : first_of(c_end);

  const int64_t c = c0 + threadIdx.x;
  if (c < n_chunks) {
    const int b = (int)(c / cpr);
    const int o0 = (int)(c - (int64_t)b * cpr) * CHUNK;
    const int o_end = min(o0 + CHUNK, P);
    // window o is valid iff o <= len - span, o < limit, no ambiguous base
    // among its key's bases
    const int o_hi = min(min(P, lengths[b] - span + 1), limits[b]);
    const void* row = static_cast<const char*>(codes) +
                      (size_t)b * row_stride * (PACKED ? 4 : 1);
    const int64_t s0 = first_of(c) - f0;
    for (int o = o0; o < o_end; ++o) {
      bool ok = o < o_hi;
      KEY v;
      bool amb;
      v = kmer::gather_key<KEY, PACKED, CANON>(row, o, pos, n, L, amb);
      ok = ok && !(mask_amb && amb);
      int64_t hi = kmer::SENTINEL, lo = kmer::SENTINEL;
      if (ok) kmer::split_key(v, n, hi, lo);
      const int slot = stage_slot<CHUNK>(s0 + (o - o0));
      stage[0][slot] = hi;
      if constexpr (TWO) stage[1][slot] = lo;
    }
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < f1 - f0; i += THREADS) {
    keys_hi[f0 + i] = stage[0][stage_slot<CHUNK>(i)];
    if constexpr (TWO) keys_lo[f0 + i] = stage[1][stage_slot<CHUNK>(i)];
  }
}

// a spaced seed of span <= 64: the rolled span cut by the seed's table
template <typename KEY, typename SPAN, bool PACKED, bool CANON>
__global__ void __launch_bounds__(ROLLED_THREADS)
extract_rolled_kernel(const void* __restrict__ codes, int row_stride,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ limits,
                      int64_t* __restrict__ keys_hi,
                      int64_t* __restrict__ keys_lo, int B, int L, int n,
                      int span, int P, int cpr, int mask_amb, kmer::Cut cut) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  constexpr int C = ROLLED_CHUNK, T = ROLLED_THREADS;
  __shared__ int64_t stage[TWO ? 2 : 1][ROLLED_STAGE];
  __shared__ kmer::Cut cut_sh;
  kmer::load_cut(cut_sh, cut);
  __syncthreads();
  const int64_t n_chunks = (int64_t)B * cpr;
  const int64_t c0 = (int64_t)blockIdx.x * T;
  const int64_t c_end = c0 + T < n_chunks ? c0 + T : n_chunks;
  // flat output index of the first key of chunk c
  auto first_of = [&](int64_t c) -> int64_t {
    const int64_t b = c / cpr;
    return b * P + (c - b * cpr) * C;
  };
  const int64_t f0 = first_of(c0);
  const int64_t f1 = c_end == n_chunks ? (int64_t)B * P : first_of(c_end);

  const int64_t c = c0 + threadIdx.x;
  if (c < n_chunks) {
    const int b = (int)(c / cpr);
    const int o0 = (int)(c - (int64_t)b * cpr) * C;
    const int o_end = min(o0 + C, P);
    // window o is valid iff o <= len - span, o < limit, no ambiguous base
    // at a selected offset
    const int o_hi = min(min(P, lengths[b] - span + 1), limits[b]);
    const void* row = static_cast<const char*>(codes) +
                      (size_t)b * row_stride * (PACKED ? 4 : 1);
    typedef kmer::SpanWalk<KEY, SPAN, PACKED, CANON> Walk;
    constexpr int G = Walk::G;     // windows whose keys are cut at once
    Walk win(row, L, span, mask_amb, cut_sh);
    win.prime(o0);
    const int64_t s0 = first_of(c) - f0;
    for (int o = o0; o < o_end; o += G) {
      bool ok[G];
      KEY v[G];
#pragma unroll
      for (int j = 0; j < G; ++j) ok[j] = o + j < o_hi;
      win.keys(o, ok, v);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (o + j >= o_end) break;
        int64_t hi = kmer::SENTINEL, lo = kmer::SENTINEL;
        if (ok[j]) kmer::split_key(v[j], n, hi, lo);
        const int slot = stage_slot<C>(s0 + (o + j - o0));
        stage[0][slot] = hi;
        if constexpr (TWO) stage[1][slot] = lo;
      }
    }
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < f1 - f0; i += T) {
    keys_hi[f0 + i] = stage[0][stage_slot<C>(i)];
    if constexpr (TWO) keys_lo[f0 + i] = stage[1][stage_slot<C>(i)];
  }
}

// ---- Keys of more than two words, and the gapped lanes ----

// A row read straight from device memory: the 64 bits of the packed stream
// from base q (0 past the row's width), and with them the ambiguity bits
// of the same bases (u8 rows: 01 a base whose code is >= 4).
template <bool PACKED>
struct GlobalRow {
  const void* row;
  int L, words;              // words: ceil(L / 16)

  __device__ __forceinline__ uint32_t word(int j, uint32_t& amb) const {
    amb = 0u;
    return j < words ? kmer::row_word<PACKED>(row, j, L, amb) : 0u;
  }
  __device__ __forceinline__ uint64_t cut(int q, uint64_t& amb) const {
    const int j = q >> 4, s = 2 * (q & 15);
    uint32_t a0, a1, a2;
    const uint32_t w0 = word(j, a0), w1 = word(j + 1, a1),
                   w2 = word(j + 2, a2);
    amb = (uint64_t)__funnelshift_l(a1, a0, s) << 32 |
          __funnelshift_l(a2, a1, s);
    return (uint64_t)__funnelshift_l(w1, w0, s) << 32 |
           __funnelshift_l(w2, w1, s);
  }
  // the value of the m <= 32 bases from q (top-aligned cut, shifted down)
  __device__ __forceinline__ uint64_t seg(int q, int m) const {
    uint64_t a;
    return cut(q, a) >> (64 - 2 * m);
  }
  // some base of [q, q + m) is ambiguous (any m)
  __device__ __forceinline__ bool ambiguous(int q, int m) const {
    for (int t = 0; t < m; t += 32) {
      uint64_t a;
      cut(q + t, a);
      const int b = m - t < 32 ? m - t : 32;
      if (a >> (64 - 2 * b)) return true;
    }
    return false;
  }
};

// the stored form of a word of b bases: a 32-base word's top bit flipped
__device__ __forceinline__ int64_t stored(uint64_t v, int b) {
  return (int64_t)(b == 32 ? v ^ (1ull << 63) : v);
}

// the forward word j of a key of n bases (W words, the last of `rest`
// bases) at q of a slot's packed words f: its bases' cut, shifted down
__device__ __forceinline__ uint64_t fw_word(const uint32_t* f, int q, int n,
                                            int W, int rest, int j) {
  const int bj = j < W - 1 ? kmer::HI_BASES : rest;
  return kmer::cut64(f, q + kmer::HI_BASES * j) >> (64 - 2 * bj);
}

// the reverse complement's word j: the top 62 bits of rc64 of the cut at
// q + n - 31 j - 32, and for the last word the low 2 rest bits of rc64 of
// the cut at q
__device__ __forceinline__ uint64_t rc_word(const uint32_t* f, int q, int n,
                                            int W, int rest, int j) {
  if (j < W - 1)
    return kmer::rc64(kmer::cut64(f, q + n - kmer::HI_BASES * j - 32)) >> 2;
  const uint64_t x = kmer::rc64(kmer::cut64(f, q));
  return rest == 32 ? x : x & ((1ull << 2 * rest) - 1);
}

// some base of the n from q of a slot's ambiguity words a is ambiguous
__device__ __forceinline__ bool span_ambiguous(const uint32_t* a, int q,
                                               int n) {
  for (int t = 0; t < n; t += 32) {
    const int m = n - t < 32 ? n - t : 32;
    if (kmer::cut64(a, q + t) >> (64 - 2 * m)) return true;
  }
  return false;
}

// A contiguous key of n > 63 bases in W = words64(n) words (ops/encode's
// general layout; `rest` the last word's bases), out: W planes of the flat
// (B, P) lanes, plane stride B P, cut out of the block's tile.  A block
// takes `iters` x CUT_THREADS consecutive outputs, as extract_cut_kernel
// takes its tile, and stages the rows they touch once (CutTile: packed
// words and, for u8 rows under the ambiguity mask, ambiguity words, each
// slot from its first window), with each row's last valid window after
// them.  Thread t takes outputs l0 + t, l0 + t + CUT_THREADS, ...: one
// 32-bit division gives its first (slot, window), and each step adds the
// host's (CUT_THREADS / P, CUT_THREADS % P) with one carry.  Word j of the
// forward key is the cut of 31 bases at o + 31 j (rest for the last);
// rc_word gives the reverse complement's.  The canonical key compares the
// two strands word by word up to the first difference (one word but for a
// 31-base tie), which gives the chosen strand's first word, then cuts the
// chosen strand's other words, so no word is held: one cut a word at a
// position and with a transform chosen by selects, not by branches (the
// lanes of a warp take either strand).  The stores go plane by plane, a
// warp's 32 lanes on 256 contiguous bytes of each plane.
template <bool PACKED, bool CANON>
__global__ void __launch_bounds__(CUT_THREADS)
extract_wide_tile_kernel(const void* __restrict__ codes, int row_stride,
                         const int32_t* __restrict__ lengths,
                         const int32_t* __restrict__ limits,
                         int64_t* __restrict__ out, int B, int L, int n,
                         int W, int P, int mask_amb, int iters, int cap,
                         int stride, int step_rows, int step_rest) {
  extern __shared__ uint32_t wide_sm[];
  const int rest = n - kmer::HI_BASES * (W - 1);
  const int64_t total = (int64_t)B * P;
  const int64_t f0 = (int64_t)blockIdx.x * CUT_THREADS * iters;
  const int64_t f_end = f0 + (int64_t)CUT_THREADS * iters;
  const int64_t f1 = f_end < total ? f_end : total;
  // the tile's rows b0 .. and its outputs [l0, l1) counted from row b0's
  // first; slot s serves row b0 + s over windows [first(s), l1 - s P)
  const int b0 = (int)(f0 / P);
  const int64_t base = (int64_t)b0 * P;
  const int l0 = (int)(f0 - base), l1 = (int)(f1 - base);
  const int slots = (l1 - 1) / P + 1;
  auto first = [=](int s) { return max(l0 - s * P, 0); };
  const bool amb = !PACKED && mask_amb != 0;
  const kmer::CutTile tile = {wide_sm, cap, stride, n, (L + 15) / 16, amb};
  // window o of slot s is valid iff o < o_hi[s] (o <= len - n, o < limit)
  // and no base of it is ambiguous
  int* o_hi = reinterpret_cast<int*>(wide_sm + slots * stride);
  for (int s = threadIdx.x; s < slots; s += CUT_THREADS)
    o_hi[s] = min(lengths[b0 + s] - n + 1, limits[b0 + s]);
  tile.stage<PACKED>(codes, row_stride, L, b0, slots, first);

  // the last word: its shift down from a forward cut, its mask in rc64 of
  // the cut at o, the stored flip of a 32-base word
  const int last_shift = 64 - 2 * rest;
  const uint64_t last_mask = rest == 32 ? ~0ull : (1ull << 2 * rest) - 1;
  const uint64_t last_flip = rest == 32 ? 1ull << 63 : 0;
  int i = l0 + threadIdx.x;
  int s = i / P, o = i - s * P;
  for (; i < l1; i += CUT_THREADS) {
    const uint32_t* f = wide_sm + s * stride;
    const int q = o - 16 * (first(s) >> 4);
    bool ok = o < o_hi[s];
    if (amb && ok) ok = !span_ambiguous(f + cap, q, n);
    int64_t* dst = out + base + i;
    // the strand, and its word 0
    uint64_t w0 = fw_word(f, q, n, W, rest, 0);
    bool rc = false;
    if constexpr (CANON) {
      const uint64_t r0 = rc_word(f, q, n, W, rest, 0);
      rc = r0 < w0;
      for (int j = 1; j < W && r0 == w0; ++j) {
        const uint64_t x = fw_word(f, q, n, W, rest, j),
                       y = rc_word(f, q, n, W, rest, j);
        if (x != y) {
          rc = y < x;
          break;
        }
      }
      w0 = rc ? r0 : w0;
    }
    dst[0] = ok ? (int64_t)w0 : kmer::SENTINEL;
    // words 1 .. W - 1: the forward cut at q + 31 j, or the reverse
    // complement's at q + n - 31 j - 32 (q for the last word)
    int at = rc ? q + n - kmer::HI_BASES - 32 : q + kmer::HI_BASES;
    const int step = rc ? -kmer::HI_BASES : kmer::HI_BASES;
    for (int j = 1; j < W; ++j, at += step) {
      const bool last = j == W - 1;
      const uint64_t x = kmer::cut64(f, rc && last ? q : at);
      uint64_t v = x >> (last ? last_shift : 2);
      if constexpr (CANON) {
        const uint64_t r = kmer::rc64(x);
        v = rc ? (last ? r & last_mask : r >> 2) : v;
      }
      if (last) v ^= last_flip;
      dst[j * total] = ok ? (int64_t)v : kmer::SENTINEL;
    }
    o += step_rest;
    s += step_rows;
    if (o >= P) {
      o -= P;
      ++s;
    }
  }
}

// A contiguous key of n > 63 bases, as extract_wide_tile_kernel computes
// it, for a batch whose tile would not fit the block's shared memory
// (rows so wide that even CUT_THREADS outputs touch over CUT_SMEM bytes of
// them): one thread a lane, its bases cut straight from the row in device
// memory (GlobalRow), the canonical key in the same two walks.
template <bool PACKED, bool CANON>
__global__ void __launch_bounds__(CUT_THREADS)
extract_wide_kernel(const void* __restrict__ codes, int row_stride,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ limits,
                    int64_t* __restrict__ out, int B, int L, int n, int W,
                    int P, int mask_amb) {
  const int rest = n - kmer::HI_BASES * (W - 1);
  const int64_t total = (int64_t)B * P;
  for (int64_t f = (int64_t)blockIdx.x * CUT_THREADS + threadIdx.x;
       f < total; f += (int64_t)gridDim.x * CUT_THREADS) {
    const int b = (int)(f / P), o = (int)(f - (int64_t)b * P);
    const GlobalRow<PACKED> row = {
        static_cast<const char*>(codes) +
            (size_t)b * row_stride * (PACKED ? 4 : 1),
        L, (L + 15) / 16};
    bool ok = o < min(lengths[b] - n + 1, limits[b]);
    if (!PACKED && mask_amb) ok = ok && !row.ambiguous(o, n);
    auto fw = [&](int j) {
      return row.seg(o + kmer::HI_BASES * j,
                     j < W - 1 ? kmer::HI_BASES : rest);
    };
    auto rc = [&](int j) -> uint64_t {
      uint64_t a;
      if (j < W - 1)
        return kmer::rc64(row.cut(o + n - kmer::HI_BASES * j - 32, a)) >> 2;
      const uint64_t x = kmer::rc64(row.cut(o, a));
      return rest == 32 ? x : x & ((1ull << 2 * rest) - 1);
    };
    bool use_rc = false;
    if constexpr (CANON) {
      for (int j = 0; j < W; ++j) {
        const uint64_t x = fw(j), y = rc(j);
        if (x != y) {
          use_rc = y < x;
          break;
        }
      }
    }
    for (int j = 0; j < W; ++j) {
      const int bj = j < W - 1 ? kmer::HI_BASES : rest;
      out[j * total + f] =
          ok ? stored(use_rc ? rc(j) : fw(j), bj) : kmer::SENTINEL;
    }
  }
}


// The gapped L+R lanes of the unfused route: lane t of row b is chunk size
// c and offset o of the c-major stream (ops/extract.gapped_lanes: O_c = L
// - c + 1 lanes a chunk size, c from c_min up to min(c_max, L)), out: the
// planes of ops/encode.gapped_bases over the flat (B, T) lanes, plane
// stride B T.  SPLIT (l_len, r_len <= 31): K3's two words, the L window's
// value and the R window's; else the words of the string L||R, a word that
// straddles the two windows cut from both.  One thread a lane, its
// windows cut straight from the row; c comes from t by the closed form of
// the stream's prefix sums, corrected by one step either way.
template <bool PACKED, bool SPLIT>
__global__ void __launch_bounds__(CUT_THREADS)
extract_gapped_kernel(const void* __restrict__ codes, int row_stride,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ limits,
                      int64_t* __restrict__ out, int B, int L, int l_len,
                      int r_len, int c_min, int T, int W, int mask_amb) {
  const int n = l_len + r_len;
  const int64_t total = (int64_t)B * T;
  const int64_t A = (int64_t)L - c_min + 1;    // lanes of chunk size c_min
  // lanes before chunk size c_min + d
  auto before = [A](int64_t d) { return d * A - d * (d - 1) / 2; };
  for (int64_t f = (int64_t)blockIdx.x * CUT_THREADS + threadIdx.x;
       f < total; f += (int64_t)gridDim.x * CUT_THREADS) {
    const int b = (int)(f / T);
    const int64_t t = f - (int64_t)b * T;
    const double h = (double)(2 * A + 1);
    int64_t d = (int64_t)((h - sqrt(h * h - 8.0 * (double)t)) / 2.0);
    if (d < 0) d = 0;
    while (d > 0 && before(d) > t) --d;
    while (before(d + 1) <= t) ++d;
    const int c = c_min + (int)d, o = (int)(t - before(d));
    const int q = c - r_len;                   // the R window's start
    const GlobalRow<PACKED> row = {
        static_cast<const char*>(codes) +
            (size_t)b * row_stride * (PACKED ? 4 : 1),
        L, (L + 15) / 16};
    bool ok = o + c <= lengths[b] && o < limits[b];
    if (!PACKED && mask_amb)
      ok = ok && !row.ambiguous(o, l_len) && !row.ambiguous(o + q, r_len);
    if constexpr (SPLIT) {
      out[f] = ok ? (int64_t)row.seg(o, l_len) : kmer::SENTINEL;
      out[total + f] = ok ? (int64_t)row.seg(o + q, r_len) : kmer::SENTINEL;
    } else {
      // the m bases of L||R from its base u: a cut of each window they
      // touch
      auto value = [&](int u, int m) -> uint64_t {
        if (u + m <= l_len) return row.seg(o + u, m);
        if (u >= l_len) return row.seg(o + q + u - l_len, m);
        const int m2 = u + m - l_len;
        return row.seg(o + u, m - m2) << 2 * m2 | row.seg(o + q, m2);
      };
      const int rest = n - kmer::HI_BASES * (W - 1);
      for (int j = 0; j < W; ++j) {
        const int bj = j < W - 1 ? kmer::HI_BASES : rest;
        int64_t v = kmer::SENTINEL;
        if (ok) {
          const int u = kmer::HI_BASES * j;
          // a 32-base word: its first base, then 31
          v = bj < 32 ? (int64_t)value(u, bj)
                      : stored(value(u, 1) << 62 | value(u + 1, 31), 32);
        }
        out[j * total + f] = v;
      }
    }
  }
}

// one batch's launch arguments; kmer::dispatch picks the body and its
// template arguments.  With `info`, each body reports its launch
// (kmer::report) instead of making it.
struct Launch {
  cudaStream_t st;
  const void* codes;
  int row_stride;
  const int32_t *lengths, *limits;
  int64_t *keys_hi, *keys_lo;
  int B, L, n, span, P, mask_amb;
  kmer::Offsets off;
  kmer::Cut cut;
  int* info;

  template <typename K, typename... A>
  void launch(K kernel, unsigned blocks, int threads, size_t smem,
              A... args) const {
    if (info)
      kmer::report(info, kernel, blocks, threads, smem);
    else
      kernel<<<blocks, threads, smem, st>>>(args...);
  }
  // blocks of `threads` chunks of `chunk` windows: (blocks, chunks a row)
  std::pair<unsigned, int> tile(int chunk, int threads) const {
    const int cpr = (P + chunk - 1) / chunk;
    return {(unsigned)(((int64_t)B * cpr + threads - 1) / threads), cpr};
  }
  // the cut body: `iters` keys a thread, as many as keep the grid at about
  // the card's thread slots (at most MAX_ITERS, fewer where the tile's rows
  // would outgrow CUT_SMEM)
  template <typename KEY, bool PACKED, bool CANON>
  void contiguous() const {
    const int64_t total = (int64_t)B * P;
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    int iters = (int)std::min<int64_t>(
        MAX_ITERS, std::max<int64_t>(1, total / ((int64_t)sms * per_sm)));
    int cap, stride;
    int64_t smem;
    for (;; --iters) {
      // a tile's outputs touch at most slots rows, each over at most
      // min(P, outputs) windows
      const int t = CUT_THREADS * iters;
      const int64_t slots = std::min<int64_t>(B, (t + P - 2) / P + 1);
      kmer::tile_shape(std::min(P, t), n, !PACKED && mask_amb, cap, stride);
      smem = slots * stride * 4;
      if (smem <= CUT_SMEM || iters == 1) break;
    }
    const int64_t per_block = (int64_t)CUT_THREADS * iters;
    launch(extract_cut_kernel<KEY, PACKED, CANON>,
           (unsigned)((total + per_block - 1) / per_block), CUT_THREADS,
           (size_t)smem, codes, row_stride, lengths, limits, keys_hi,
           keys_lo, B, L, n, P, mask_amb, iters, cap, stride);
  }
  template <typename KEY, bool PACKED, bool CANON>
  void gather() const {
    const auto [blocks, cpr] = tile(CHUNK, THREADS);
    launch(extract_gather_kernel<KEY, PACKED, CANON>, blocks, THREADS, 0,
           codes, row_stride, lengths, limits, keys_hi, keys_lo, B, L, n,
           span, P, cpr, mask_amb, off);
  }
  template <typename KEY, typename SPAN, bool PACKED, bool CANON>
  void rolled() const {
    const auto [blocks, cpr] = tile(ROLLED_CHUNK, ROLLED_THREADS);
    launch(extract_rolled_kernel<KEY, SPAN, PACKED, CANON>, blocks,
           ROLLED_THREADS, 0, codes, row_stride, lengths, limits, keys_hi,
           keys_lo, B, L, n, span, P, cpr, mask_amb, cut);
  }
};

// the launch (info == nullptr) or its report
int launch_or_report(const void* codes, int packed, int row_stride,
                     const int32_t* lengths, const int32_t* limits,
                     int64_t* keys_hi, int64_t* keys_lo, int B, int L, int n,
                     int span, int canonical, int mask_amb,
                     const int32_t* positions, const uint32_t* cut,
                     void* stream, int* info) {
  const int P = L - span + 1;
  const bool rolled = positions != nullptr && span <= kmer::MAX_ROLLED_SPAN;
  if (n < 1 || n > kmer::MAX_BASES || B < 1 || P < 1 ||
      (positions == nullptr && span != n) || (rolled && cut == nullptr) ||
      (n > kmer::HI_BASES && keys_lo == nullptr) ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L))
    return (int)cudaErrorInvalidValue;
  // the most blocks any body's tile gives: the cut body's at one key a
  // thread, the others' at a chunk a thread
  const int64_t chunks = (int64_t)B * ((P + CHUNK - 1) / CHUNK);
  if ((chunks + ROLLED_THREADS - 1) / ROLLED_THREADS > 0x7FFFFFFF ||
      ((int64_t)B * P + CUT_THREADS - 1) / CUT_THREADS > 0x7FFFFFFF ||
      P > 0x7FFFFFFF - CUT_THREADS * MAX_ITERS)
    return (int)cudaErrorInvalidValue;
  const Launch l = {static_cast<cudaStream_t>(stream), codes, row_stride,
                    lengths, limits, keys_hi, keys_lo, B, L, n, span, P,
                    mask_amb, kmer::offsets_of(positions, n),
                    kmer::cut_of(rolled ? cut : nullptr), info};
  kmer::dispatch(l, n, packed, canonical, positions != nullptr, span);
  return info ? info[kmer::INFO_INTS - 1] : (int)cudaGetLastError();
}

}  // namespace

// codes: (B, row_stride) int32 words of 16 packed bases (packed != 0) or
// (B, row_stride) uint8 codes (code >= 4 ambiguous); lengths/limits: (B,)
// int32.  A key of n bases: contiguous (positions == nullptr, span = n) or
// a spaced seed's bases at window offsets positions[0 .. n) (host memory,
// checked by the caller: ascending, positions[0] = 0, span = positions[n -
// 1] + 1) with, for a span of at most 64 bases, its cut table `cut` of
// kmer::CUT_TABLE_WORDS words (ops/extract.seed_cut_table).  keys_hi: (B,
// L - span + 1) int64, the key for n <= 31, else the hi word of the pair
// whose lo word is keys_lo, of the same shape (unused for n <= 31).
// Returns the launch's cudaError_t.
extern "C" int extract_launch(const void* codes, int packed, int row_stride,
                              const int32_t* lengths, const int32_t* limits,
                              int64_t* keys_hi, int64_t* keys_lo, int B,
                              int L, int n, int span, int canonical,
                              int mask_amb, const int32_t* positions,
                              const uint32_t* cut, void* stream) {
  return launch_or_report(codes, packed, row_stride, lengths, limits,
                          keys_hi, keys_lo, B, L, n, span, canonical,
                          mask_amb, positions, cut, stream, nullptr);
}

// the launch that extract_launch would make with the same arguments (no
// pointer is read), reported into info[0 .. 7) as kmer::report lays it
// out; returns the cudaError_t of the queries
extern "C" int extract_info(int packed, int row_stride, int B, int L, int n,
                            int span, int canonical, int mask_amb,
                            const int32_t* positions, const uint32_t* cut,
                            int* info) {
  int64_t dummy[1];
  return launch_or_report(nullptr, packed, row_stride, nullptr, nullptr,
                          dummy, dummy, B, L, n, span, canonical, mask_amb,
                          positions, cut, nullptr, info);
}

// the cut table's layout (kmer::cut_layout): CUT_WORDS, CUT_TABLE_WORDS,
// MAX_ROLLED_SPAN
extern "C" void cut_layout(int32_t* out) { kmer::cut_layout(out); }

// ---- The wide and gapped entries ----

namespace {

// blocks for a flat lane stream: enough for every lane, at most the
// card's resident blocks times eight (the threads then stride)
template <typename K>
unsigned flat_blocks(K kernel, int64_t total) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CUT_THREADS,
                                                0);
  const int64_t need = (total + CUT_THREADS - 1) / CUT_THREADS;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1) * 8;
  return (unsigned)(need < cap ? need : cap);
}

// The multi-word body's plan: the tile body with `iters` outputs a
// thread (the fewest that keep the grid within one wave of the card's
// `thread_slots`, at most MAX_ITERS) and its tile's (cap, stride) and
// shared bytes (the staged words and o_hi), fewer iters where the tile's
// rows would outgrow CUT_SMEM; the row body when even one output a thread
// would.
struct WidePlan {
  bool tile;
  int iters, cap, stride;
  int64_t smem;
};

WidePlan wide_plan(int B, int n, int P, bool amb, int64_t thread_slots) {
  const int64_t total = (int64_t)B * P;
  const int64_t slots_all = std::max<int64_t>(1, thread_slots);
  WidePlan pl = {};
  pl.iters = (int)std::min<int64_t>(
      MAX_ITERS, std::max<int64_t>(1, (total + slots_all - 1) / slots_all));
  for (;; --pl.iters) {
    // a tile's outputs touch at most `slots` rows, each over at most
    // min(P, outputs) windows
    const int t = CUT_THREADS * pl.iters;
    const int64_t slots = std::min<int64_t>(B, (t + P - 2) / P + 1);
    kmer::tile_shape(std::min(P, t), n, amb, pl.cap, pl.stride);
    pl.smem = slots * (pl.stride + 1) * 4;
    pl.tile = pl.smem <= CUT_SMEM;
    if (pl.tile || pl.iters == 1) return pl;
  }
}

// the card's thread slots for `kernel`: SMs x its resident blocks an SM
// (its registers decide) x CUT_THREADS
template <typename K>
int64_t thread_slots(K kernel) {
  int dev = 0, sms = 1, blocks = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, CUT_THREADS,
                                                0);
  return (int64_t)sms * std::max(blocks, 1) * CUT_THREADS;
}

int64_t wide_slots(bool packed, bool canon) {
  if (packed)
    return canon ? thread_slots(extract_wide_tile_kernel<true, true>)
                 : thread_slots(extract_wide_tile_kernel<true, false>);
  return canon ? thread_slots(extract_wide_tile_kernel<false, true>)
               : thread_slots(extract_wide_tile_kernel<false, false>);
}

template <bool PACKED, bool CANON>
int wide_launch(const void* codes, int row_stride, const int32_t* lengths,
                const int32_t* limits, int64_t* out, int B, int L, int n,
                int W, int P, int mask_amb, cudaStream_t st, int* info) {
  const int64_t total = (int64_t)B * P;
  const WidePlan pl = wide_plan(B, n, P, !PACKED && mask_amb != 0,
                                wide_slots(PACKED, CANON));
  if (pl.tile) {
    auto kern = extract_wide_tile_kernel<PACKED, CANON>;
    const int64_t per_block = (int64_t)CUT_THREADS * pl.iters;
    const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
    if (info) {
      kmer::report(info, kern, blocks, CUT_THREADS, (size_t)pl.smem);
      return info[kmer::INFO_INTS - 1];
    }
    kern<<<blocks, CUT_THREADS, (size_t)pl.smem, st>>>(
        codes, row_stride, lengths, limits, out, B, L, n, W, P, mask_amb,
        pl.iters, pl.cap, pl.stride, CUT_THREADS / P, CUT_THREADS % P);
    return (int)cudaGetLastError();
  }
  auto kern = extract_wide_kernel<PACKED, CANON>;
  const unsigned blocks = flat_blocks(kern, total);
  if (info) {
    kmer::report(info, kern, blocks, CUT_THREADS, 0);
    return info[kmer::INFO_INTS - 1];
  }
  kern<<<blocks, CUT_THREADS, 0, st>>>(codes, row_stride, lengths, limits,
                                       out, B, L, n, W, P, mask_amb);
  return (int)cudaGetLastError();
}

template <bool PACKED, bool SPLIT>
int gapped_launch(const void* codes, int row_stride, const int32_t* lengths,
                  const int32_t* limits, int64_t* out, int B, int L,
                  int l_len, int r_len, int c_min, int T, int W,
                  int mask_amb, cudaStream_t st, int* info) {
  auto kern = extract_gapped_kernel<PACKED, SPLIT>;
  const unsigned blocks = flat_blocks(kern, (int64_t)B * T);
  if (info) {
    kmer::report(info, kern, blocks, CUT_THREADS, 0);
    return info[kmer::INFO_INTS - 1];
  }
  kern<<<blocks, CUT_THREADS, 0, st>>>(codes, row_stride, lengths, limits,
                                       out, B, L, l_len, r_len, c_min, T, W,
                                       mask_amb);
  return (int)cudaGetLastError();
}

int wide_or_report(const void* codes, int packed, int row_stride,
                   const int32_t* lengths, const int32_t* limits,
                   int64_t* out, int B, int L, int n, int W, int canonical,
                   int mask_amb, void* stream, int* info) {
  const int P = L - n + 1;
  if (n <= kmer::MAX_BASES || B < 1 || P < 1 || W < 3 ||
      (n - 2) / kmer::HI_BASES + 1 != W ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L) ||
      ((int64_t)B * P + CUT_THREADS - 1) / CUT_THREADS > 0x7FFFFFFF ||
      P > 0x7FFFFFFF - CUT_THREADS * MAX_ITERS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed)
    return canonical ? wide_launch<true, true>(codes, row_stride, lengths,
                                               limits, out, B, L, n, W, P,
                                               mask_amb, st, info)
                     : wide_launch<true, false>(codes, row_stride, lengths,
                                                limits, out, B, L, n, W, P,
                                                mask_amb, st, info);
  return canonical ? wide_launch<false, true>(codes, row_stride, lengths,
                                              limits, out, B, L, n, W, P,
                                              mask_amb, st, info)
                   : wide_launch<false, false>(codes, row_stride, lengths,
                                               limits, out, B, L, n, W, P,
                                               mask_amb, st, info);
}

int gapped_or_report(const void* codes, int packed, int row_stride,
                     const int32_t* lengths, const int32_t* limits,
                     int64_t* out, int B, int L, int l_len, int r_len,
                     int c_min, int T, int W, int mask_amb, void* stream,
                     int* info) {
  const bool split = l_len <= kmer::HI_BASES && r_len <= kmer::HI_BASES;
  const int n = l_len + r_len;
  // K3's split, or the general layout of n >= 33 bases
  const int want = split ? 2 : (n - 2) / kmer::HI_BASES + 1;
  if (B < 1 || T < 1 || l_len < 1 || r_len < 1 || c_min < n || W != want ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed)
    return split ? gapped_launch<true, true>(codes, row_stride, lengths,
                                             limits, out, B, L, l_len, r_len,
                                             c_min, T, W, mask_amb, st, info)
                 : gapped_launch<true, false>(codes, row_stride, lengths,
                                              limits, out, B, L, l_len, r_len,
                                              c_min, T, W, mask_amb, st,
                                              info);
  return split ? gapped_launch<false, true>(codes, row_stride, lengths,
                                            limits, out, B, L, l_len, r_len,
                                            c_min, T, W, mask_amb, st, info)
               : gapped_launch<false, false>(codes, row_stride, lengths,
                                             limits, out, B, L, l_len, r_len,
                                             c_min, T, W, mask_amb, st, info);
}

}  // namespace

// A contiguous key of n > 63 bases (W = words64(n) words, ops/encode):
// codes, lengths and limits as extract_launch's; out: (W, B, L - n + 1)
// int64, SENTINEL on invalid lanes.  Returns the launch's cudaError_t.
extern "C" int extract_wide_launch(const void* codes, int packed,
                                   int row_stride, const int32_t* lengths,
                                   const int32_t* limits, int64_t* out, int B,
                                   int L, int n, int W, int canonical,
                                   int mask_amb, void* stream) {
  return wide_or_report(codes, packed, row_stride, lengths, limits, out, B,
                        L, n, W, canonical, mask_amb, stream, nullptr);
}

extern "C" int extract_wide_info(int packed, int row_stride, int B, int L,
                                 int n, int W, int canonical, int mask_amb,
                                 int* info) {
  int64_t dummy[1];
  return wide_or_report(nullptr, packed, row_stride, nullptr, nullptr, dummy,
                        B, L, n, W, canonical, mask_amb, nullptr, info);
}

// The multi-word body's plan for a (B, L) batch of keys of n bases (amb:
// u8 rows under the ambiguity mask) on a card of `slots` thread slots (0:
// the current device's for the launch's kernel): out[0] 1 for the tile
// body, 0 for the row body; then iters, cap, stride and the tile's shared
// bytes.
extern "C" void extract_wide_plan(int packed, int B, int L, int n,
                                  int canonical, int mask_amb, int64_t slots,
                                  int64_t* out) {
  const WidePlan pl =
      wide_plan(B, n, L - n + 1, !packed && mask_amb != 0,
                slots > 0 ? slots : wide_slots(packed != 0, canonical != 0));
  const int64_t v[5] = {(int64_t)pl.tile, pl.iters, pl.cap, pl.stride,
                        pl.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

// The gapped L+R lanes of chunk sizes c_min .. min(c_max, L): T lanes a
// row (ops/extract.gapped_lane_count), out: (W, B, T) int64 in the planes
// of ops/encode.gapped_bases (W = 2, K3's split, while l_len, r_len <= 31),
// SENTINEL on invalid lanes.  Returns the launch's cudaError_t.
extern "C" int extract_gapped_launch(const void* codes, int packed,
                                     int row_stride, const int32_t* lengths,
                                     const int32_t* limits, int64_t* out,
                                     int B, int L, int l_len, int r_len,
                                     int c_min, int T, int W, int mask_amb,
                                     void* stream) {
  return gapped_or_report(codes, packed, row_stride, lengths, limits, out, B,
                          L, l_len, r_len, c_min, T, W, mask_amb, stream,
                          nullptr);
}

extern "C" int extract_gapped_info(int packed, int row_stride, int B, int L,
                                   int l_len, int r_len, int c_min, int T,
                                   int W, int mask_amb, int* info) {
  int64_t dummy[1];
  return gapped_or_report(nullptr, packed, row_stride, nullptr, nullptr,
                          dummy, B, L, l_len, r_len, c_min, T, W, mask_amb,
                          nullptr, info);
}
