// Row-layout k-mer extraction for Hopper (sm_90a): the key of every window
// start of every row, canonical on request, SENTINEL on invalid lanes, with
// no collapse.  It feeds the unfused count step (the grouped counts of
// csrc/grouped_count.cu, or the flat sort of csrc/sort.cu).
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/extract.py `_extract_kernel`
// (entry extract_repacked).
//
// What bounds it: memory.  Each output lane is one 8-byte key store; the
// input is L/4 bytes of packed codes a row (L bytes for u8 rows) and two
// int32 a row; the arithmetic is a few integer operations per base.
//
// Design: the TPU kernel builds every window of a row block at once from k
// shifted slices and splits the key into the (top, bot) uint32 words of its
// sort layout, so it takes only 17 <= k <= 31 and no ambiguous codes.  Here
// a key is one int64, so every k <= 31 and the ambiguity mask come at no
// cost.  One thread walks CHUNK consecutive window starts of one row with a
// rolling forward value and reverse complement in 64-bit registers (as
// csrc/fused_extract.cu), primed with the k - 1 bases before its chunk.
// Thread t of the grid takes chunk t of the flat (B, P) output, row-major,
// so the chunks of a block cover one contiguous range of the output: the
// block stages its keys in shared memory and stores the range with
// neighbouring threads on neighbouring addresses.  The staging index skips
// one slot every CHUNK slots, so the 16 threads of a half-warp that write
// key j of their chunks fall in different banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 16;      // window starts per thread
constexpr int THREADS = 128;
constexpr int STAGE = THREADS * CHUNK + THREADS;   // keys + one pad slot a chunk
constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;
static_assert(CHUNK % 16 == 0, "a chunk starts on a packed word");

__device__ __forceinline__ int stage_slot(int64_t i) {
  return (int)(i + i / CHUNK);
}

template <bool PACKED, bool CANON>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const void* __restrict__ codes, int row_stride,
               const int32_t* __restrict__ lengths,
               const int32_t* __restrict__ limits, int64_t* __restrict__ keys,
               int B, int k, int P, int cpr, int mask_amb) {
  __shared__ int64_t stage[STAGE];
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
    // window o is valid iff o <= len - k, o < limit, no ambiguous base
    const int o_hi = min(min(P, lengths[b] - k + 1), limits[b]);
    const uint64_t mask = (1ull << (2 * k)) - 1;
    const int rc_shift = 2 * k - 2;
    uint64_t fw = 0, rc = 0;
    int last_amb = -1;
    uint32_t word = 0;
    const uint32_t* prow =
        static_cast<const uint32_t*>(codes) + (size_t)b * row_stride;
    const uint8_t* urow =
        static_cast<const uint8_t*>(codes) + (size_t)b * row_stride;
    // append base q (q runs up from o0, a multiple of 16, and stays < L)
    auto push = [&](int q) {
      uint32_t v;
      if constexpr (PACKED) {
        if ((q & 15) == 0) word = __ldg(prow + (q >> 4));
        v = (word >> (30 - 2 * (q & 15))) & 3u;
      } else {
        v = __ldg(urow + q);
        if (v >= 4u) {
          if (mask_amb) last_amb = q;
          v &= 3u;
        }
      }
      fw = ((fw << 2) | v) & mask;
      if constexpr (CANON) rc = (rc >> 2) | ((uint64_t)(3u - v) << rc_shift);
    };
    for (int q = o0; q < o0 + k - 1; ++q) push(q);
    const int64_t s0 = first_of(c) - f0;
    for (int o = o0; o < o_end; ++o) {
      push(o + k - 1);
      uint64_t v = fw;
      if constexpr (CANON) v = rc < v ? rc : v;
      stage[stage_slot(s0 + (o - o0))] =
          (o < o_hi && last_amb < o) ? (int64_t)v : SENTINEL;
    }
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < f1 - f0; i += THREADS)
    keys[f0 + i] = stage[stage_slot(i)];
}

}  // namespace

// codes: (B, row_stride) int32 words of 16 packed bases (packed != 0) or
// (B, row_stride) uint8 codes (code >= 4 ambiguous); lengths/limits: (B,)
// int32; keys: (B, L - k + 1) int64.  Returns the launch's cudaError_t.
extern "C" int extract_launch(const void* codes, int packed, int row_stride,
                              const int32_t* lengths, const int32_t* limits,
                              int64_t* keys, int B, int L, int k,
                              int canonical, int mask_amb, void* stream) {
  const int P = L - k + 1;
  if (k < 1 || k > 31 || B < 1 || P < 1 ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L))
    return (int)cudaErrorInvalidValue;
  const int cpr = (P + CHUNK - 1) / CHUNK;
  const int64_t blocks = ((int64_t)B * cpr + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KMER_LAUNCH(PK, CN)                                                 \
  extract_kernel<PK, CN><<<(unsigned)blocks, THREADS, 0, st>>>(             \
      codes, row_stride, lengths, limits, keys, B, k, P, cpr, mask_amb)
  if (packed && canonical) KMER_LAUNCH(true, true);
  else if (packed) KMER_LAUNCH(true, false);
  else if (canonical) KMER_LAUNCH(false, true);
  else KMER_LAUNCH(false, false);
#undef KMER_LAUNCH
  return (int)cudaGetLastError();
}
