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
// operations per base.
//
// Design: the TPU kernel builds every window of a row block at once from k
// shifted slices and splits the key into the (top, bot) uint32 words of its
// sort layout, so it takes only 17 <= k <= 31 and no ambiguous codes
// (kmer_tpu's unfused route extracts every other key outside a kernel).
// Here a key is one int64 or an int64 (hi, lo) pair, so every k <= 63,
// spaced seeds and the ambiguity mask come at no cost.  One thread walks
// CHUNK consecutive window starts of one row: a contiguous window rolls a
// forward value and reverse complement (64-bit registers up to 31 bases,
// 128-bit beyond), primed with the n - 1 bases before its chunk; a spaced
// window gathers its selected bases (kmer_window.cuh, shared with
// csrc/fused_extract.cu).  Thread t of the grid takes chunk t of the flat
// (B, P) output, row-major, so the chunks of a block cover one contiguous
// range of the output: the block stages its keys in shared memory (one
// plane a key word) and stores the range with neighbouring threads on
// neighbouring addresses.  The staging index skips one slot every CHUNK
// slots, so the 16 threads of a half-warp that write key j of their
// chunks fall in different banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

constexpr int CHUNK = 16;      // window starts per thread
constexpr int THREADS = 128;
constexpr int STAGE = THREADS * CHUNK + THREADS;   // keys + one pad slot a chunk
static_assert(CHUNK % 16 == 0, "a chunk starts on a packed word");

__device__ __forceinline__ int stage_slot(int64_t i) {
  return (int)(i + i / CHUNK);
}

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
      const int slot = stage_slot(s0 + (o - o0));
      stage[0][slot] = hi;
      if constexpr (TWO) stage[1][slot] = lo;
    }
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < f1 - f0; i += THREADS) {
    keys_hi[f0 + i] = stage[0][stage_slot(i)];
    if constexpr (TWO) keys_lo[f0 + i] = stage[1][stage_slot(i)];
  }
}

// one batch's launch arguments; kmer::dispatch picks the template
// arguments of run
struct Launch {
  unsigned blocks;
  cudaStream_t st;
  const void* codes;
  int row_stride;
  const int32_t *lengths, *limits;
  int64_t *keys_hi, *keys_lo;
  int B, L, n, span, P, cpr, mask_amb;
  kmer::Offsets off;

  template <typename KEY, bool PACKED, bool CANON, bool SPACED>
  void run() const {
    extract_kernel<KEY, PACKED, CANON, SPACED><<<blocks, THREADS, 0, st>>>(
        codes, row_stride, lengths, limits, keys_hi, keys_lo, B, L, n, span,
        P, cpr, mask_amb, off);
  }
};

}  // namespace

// codes: (B, row_stride) int32 words of 16 packed bases (packed != 0) or
// (B, row_stride) uint8 codes (code >= 4 ambiguous); lengths/limits: (B,)
// int32.  A key of n bases: contiguous (positions == nullptr, span = n) or
// a spaced seed's bases at window offsets positions[0 .. n) (host memory,
// checked by the caller: ascending, positions[0] = 0, span = positions[n -
// 1] + 1).  keys_hi: (B, L - span + 1) int64, the key for n <= 31, else
// the hi word of the pair whose lo word is keys_lo, of the same shape
// (unused for n <= 31).  Returns the launch's cudaError_t.
extern "C" int extract_launch(const void* codes, int packed, int row_stride,
                              const int32_t* lengths, const int32_t* limits,
                              int64_t* keys_hi, int64_t* keys_lo, int B,
                              int L, int n, int span, int canonical,
                              int mask_amb, const int32_t* positions,
                              void* stream) {
  const int P = L - span + 1;
  if (n < 1 || n > kmer::MAX_BASES || B < 1 || P < 1 ||
      (positions == nullptr && span != n) ||
      (n > kmer::HI_BASES && keys_lo == nullptr) ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L))
    return (int)cudaErrorInvalidValue;
  const int cpr = (P + CHUNK - 1) / CHUNK;
  const int64_t blocks = ((int64_t)B * cpr + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const Launch l = {(unsigned)blocks, static_cast<cudaStream_t>(stream),
                    codes, row_stride, lengths, limits, keys_hi, keys_lo, B,
                    L, n, span, P, cpr, mask_amb,
                    kmer::offsets_of(positions, n)};
  kmer::dispatch(l, n, packed, canonical, positions != nullptr);
  return (int)cudaGetLastError();
}
