// Row-layout k-mer extraction for Hopper (sm_90a): the key of every window
// start of every row, canonical on request, SENTINEL on invalid lanes, with
// no collapse.  It feeds the unfused count step (the grouped counts of
// csrc/grouped_count.cu, or the flat sort of csrc/sort.cu).
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/extract.py `_extract_kernel`
// (entry extract_repacked).
//
// What bounds it: memory.  Each output lane is one 8-byte key store (16
// for a (hi, lo) pair); the input is L/4 bytes of packed codes a row (L
// bytes for u8 rows) and two int32 a row; the arithmetic is a few integer
// operations per base, and for a spaced seed a rotate and a masked or per
// piece of its cut table.
//
// Design: the TPU kernel builds every window of a row block at once from k
// shifted slices and splits the key into the (top, bot) uint32 words of its
// sort layout, so it takes only 17 <= k <= 31 and no ambiguous codes
// (kmer_tpu's unfused route extracts every other key outside a kernel).
// Here a key is one int64 or an int64 (hi, lo) pair, so every k <= 63,
// spaced seeds and the ambiguity mask come at no cost.  One thread walks
// CHUNK consecutive window starts of one row (kmer_window.cuh, shared with
// csrc/fused_extract.cu), in one of two bodies.  extract_kernel: a
// contiguous window rolls a forward value and reverse complement (64-bit
// registers up to 31 bases, 128-bit beyond), primed with the n - 1 bases
// before its chunk; a spaced seed of span over 64 gathers its selected
// bases.  extract_rolled_kernel: a spaced seed of span <= 64 rolls its
// whole span (SpanWalk), primed with span - 1 bases, and cuts the keys of 4
// windows at a time out of the registers by the seed's cut table (each
// load of the table shared by the 4), with a rolled bit a base for
// ambiguity.  Priming span - 1 bases for 16 windows would cost more pushes
// than the windows themselves, so the rolled body takes chunks of 32
// windows in blocks of 64 threads (the staging buffer stays 33.8 KB, under
// the 48 KB of static shared memory).  Thread t of the grid takes chunk t
// of the flat (B, P) output, row-major, so the chunks of a block cover one
// contiguous range of the output: the block stages its keys in shared
// memory (one plane a key word) and stores the range with neighbouring
// threads on neighbouring addresses.  The staging index skips one slot
// every CHUNK slots, so the 16 threads of a half-warp that write key j of
// their chunks fall in different banks.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "kmer_window.cuh"

namespace {

constexpr int CHUNK = 16;      // window starts per thread
constexpr int THREADS = 128;
constexpr int STAGE = THREADS * CHUNK + THREADS;   // keys + one pad slot a chunk
static_assert(CHUNK % 16 == 0, "a chunk starts on a packed word");
// the rolled body's chunk and block
constexpr int ROLLED_CHUNK = 32, ROLLED_THREADS = 64;
constexpr int ROLLED_STAGE = ROLLED_THREADS * ROLLED_CHUNK + ROLLED_THREADS;
static_assert(ROLLED_CHUNK % 16 == 0, "a chunk starts on a packed word");

template <int C>
__device__ __forceinline__ int stage_slot(int64_t i) {
  return (int)(i + i / C);
}

// a contiguous key, or a spaced seed's gathered key (span over 64)
template <typename KEY, bool PACKED, bool CANON, bool SPACED>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const void* __restrict__ codes, int row_stride,
               const int32_t* __restrict__ lengths,
               const int32_t* __restrict__ limits,
               int64_t* __restrict__ keys_hi, int64_t* __restrict__ keys_lo,
               int B, int L, int n, int span, int P, int cpr, int mask_amb,
               kmer::Offsets off) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  __shared__ int64_t stage[TWO ? 2 : 1][STAGE];
  __shared__ int16_t pos[SPACED ? kmer::MAX_BASES : 1];
  if constexpr (SPACED) {
    if (threadIdx.x < n) pos[threadIdx.x] = off.at[threadIdx.x];
    __syncthreads();
  }
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
    kmer::RowReader<PACKED> reader(row, L, mask_amb);
    kmer::Roll<KEY> roll(n);
    if constexpr (!SPACED)
      for (int q = o0; q < o0 + n - 1; ++q)
        roll.template push<CANON>(reader.next(q));
    const int64_t s0 = first_of(c) - f0;
    for (int o = o0; o < o_end; ++o) {
      bool ok = o < o_hi;
      KEY v;
      if constexpr (SPACED) {
        bool amb;
        v = kmer::gather_key<KEY, PACKED, CANON>(row, o, pos, n, L, amb);
        ok = ok && !(mask_amb && amb);
      } else {
        roll.template push<CANON>(reader.next(o + n - 1));
        v = roll.template key<CANON>();
        ok = ok && reader.last_amb < o;
      }
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

// one batch's launch arguments; kmer::dispatch picks the template
// arguments of run or rolled
struct Launch {
  cudaStream_t st;
  const void* codes;
  int row_stride;
  const int32_t *lengths, *limits;
  int64_t *keys_hi, *keys_lo;
  int B, L, n, span, P, mask_amb;
  kmer::Offsets off;
  kmer::Cut cut;

  // blocks of `threads` chunks of `chunk` windows: (blocks, chunks a row)
  std::pair<unsigned, int> tile(int chunk, int threads) const {
    const int cpr = (P + chunk - 1) / chunk;
    return {(unsigned)(((int64_t)B * cpr + threads - 1) / threads), cpr};
  }
  template <typename KEY, bool PACKED, bool CANON, bool SPACED>
  void run() const {
    const auto [blocks, cpr] = tile(CHUNK, THREADS);
    extract_kernel<KEY, PACKED, CANON, SPACED><<<blocks, THREADS, 0, st>>>(
        codes, row_stride, lengths, limits, keys_hi, keys_lo, B, L, n, span,
        P, cpr, mask_amb, off);
  }
  template <typename KEY, typename SPAN, bool PACKED, bool CANON>
  void rolled() const {
    const auto [blocks, cpr] = tile(ROLLED_CHUNK, ROLLED_THREADS);
    extract_rolled_kernel<KEY, SPAN, PACKED, CANON>
        <<<blocks, ROLLED_THREADS, 0, st>>>(codes, row_stride, lengths,
                                            limits, keys_hi, keys_lo, B, L,
                                            n, span, P, cpr, mask_amb, cut);
  }
};

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
  const int P = L - span + 1;
  const bool rolled = positions != nullptr && span <= kmer::MAX_ROLLED_SPAN;
  if (n < 1 || n > kmer::MAX_BASES || B < 1 || P < 1 ||
      (positions == nullptr && span != n) || (rolled && cut == nullptr) ||
      (n > kmer::HI_BASES && keys_lo == nullptr) ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L))
    return (int)cudaErrorInvalidValue;
  // the most blocks either body's tile gives
  const int64_t chunks = (int64_t)B * ((P + CHUNK - 1) / CHUNK);
  if ((chunks + ROLLED_THREADS - 1) / ROLLED_THREADS > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const Launch l = {static_cast<cudaStream_t>(stream), codes, row_stride,
                    lengths, limits, keys_hi, keys_lo, B, L, n, span, P,
                    mask_amb, kmer::offsets_of(positions, n),
                    kmer::cut_of(rolled ? cut : nullptr)};
  kmer::dispatch(l, n, packed, canonical, positions != nullptr, span);
  return (int)cudaGetLastError();
}

// the cut table's layout (kmer::cut_layout): CUT_WORDS, CUT_TABLE_WORDS,
// MAX_ROLLED_SPAN
extern "C" void cut_layout(int32_t* out) { kmer::cut_layout(out); }
