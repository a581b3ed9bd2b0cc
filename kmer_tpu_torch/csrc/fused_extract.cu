// Fused k-mer count step for Hopper (sm_90a): extraction, canonical key,
// validity, sentinel and the in-segment all-pairs collapse in one pass.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/fused_extract.py `_kernel`
// (entry fused_extract_count_T) and the collapse it inlines,
// kmer_tpu/ops/pallas/fused_count.py `_dedup_runlen`.
//
// What bounds it: memory.  Each output lane costs an 8-byte key and a
// 1-byte count store; the input is L/4 bytes of packed codes per row
// (L bytes for u8 rows); the arithmetic is a few integer ops per base.
//
// Design: one thread walks CHUNK consecutive window starts of one row.
// It keeps a rolling forward value and a rolling reverse complement in
// 64-bit registers, each updated in O(1) per base, where the TPU kernel
// builds every window at once with O(log k) doubling tables or banded
// matmuls because its vector lanes carry no state along a sequence.
// Neighbouring threads take neighbouring rows, so a warp's store of
// keys[o, b .. b+31] is one contiguous 256-byte run: the output is
// position-major (P_pad, B), the TPU kernel's layout.  The collapse runs
// over the SEG keys of a segment held in registers; SEG is a template
// parameter, so the loops unroll and the register array is indexed
// statically.  Splitting each row into CHUNK-sized pieces (each primed
// with the k-1 bases before it) gives ceil(P_pad / CHUNK) times more
// threads than one thread per row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;      // window starts per thread; every SEG divides it
constexpr int THREADS = 128;
constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;

template <int SEG, bool PACKED, bool CANON>
__global__ void __launch_bounds__(THREADS)
fused_extract_kernel(const void* __restrict__ codes, int row_stride,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ limits,
                     int64_t* __restrict__ keys, int8_t* __restrict__ counts,
                     int B, int L, int k, int P, int P_pad, int mask_amb) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int o0 = blockIdx.y * CHUNK;
  const int o_end = min(o0 + CHUNK, P_pad);
  // window o is valid iff o < P, o <= len - k, o < limit, no ambiguous base
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

  // append base q (q runs up from o0, a multiple of 16); bases past the
  // row width read as 0 -- only windows o >= P, all invalid, see them
  auto push = [&](int q) {
    uint32_t c = 0;
    if (q < L) {
      if constexpr (PACKED) {
        if ((q & 15) == 0) word = __ldg(prow + (q >> 4));
        c = (word >> (30 - 2 * (q & 15))) & 3u;
      } else {
        c = __ldg(urow + q);
        if (c >= 4u) {
          if (mask_amb) last_amb = q;
          c &= 3u;
        }
      }
    }
    fw = ((fw << 2) | c) & mask;
    if constexpr (CANON) rc = (rc >> 2) | ((uint64_t)(3u - c) << rc_shift);
  };

  for (int q = o0; q < o0 + k - 1; ++q) push(q);
  for (int s = o0; s < o_end; s += SEG) {
    int64_t kk[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      const int o = s + j;
      push(o + k - 1);
      uint64_t v = fw;
      if constexpr (CANON) v = rc < v ? rc : v;
      kk[j] = (o < o_hi && last_amb < o) ? (int64_t)v : SENTINEL;
      keys[(size_t)o * B + b] = kk[j];
    }
    // count on the first occurrence: itself + equal keys later in the
    // segment; later duplicates and sentinels get 0
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      int cnt = 0;
      if (kk[i] != SENTINEL) {
        bool dup = false;
        cnt = 1;
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          if (j < i) dup |= kk[j] == kk[i];
          if (j > i) cnt += kk[j] == kk[i];
        }
        if (dup) cnt = 0;
      }
      counts[(size_t)(s + i) * B + b] = (int8_t)cnt;
    }
  }
}

template <int SEG>
void launch_seg(dim3 grid, cudaStream_t st, bool packed, bool canon,
                const void* codes, int row_stride, const int32_t* lengths,
                const int32_t* limits, int64_t* keys, int8_t* counts, int B,
                int L, int k, int P, int P_pad, int mask_amb) {
#define KMER_LAUNCH(PK, CN)                                                \
  fused_extract_kernel<SEG, PK, CN><<<grid, THREADS, 0, st>>>(             \
      codes, row_stride, lengths, limits, keys, counts, B, L, k, P, P_pad, \
      mask_amb)
  if (packed && canon) KMER_LAUNCH(true, true);
  else if (packed) KMER_LAUNCH(true, false);
  else if (canon) KMER_LAUNCH(false, true);
  else KMER_LAUNCH(false, false);
#undef KMER_LAUNCH
}

}  // namespace

// codes: (B, row_stride) int32 words of 16 packed bases (packed != 0) or
// (B, row_stride) uint8 codes; lengths/limits: (B,) int32; keys: (P_pad,
// B) int64; counts: (P_pad, B) int8.  Returns the launch's cudaError_t.
extern "C" int fused_extract_count_launch(
    const void* codes, int packed, int row_stride, const int32_t* lengths,
    const int32_t* limits, int64_t* keys, int8_t* counts, int B, int L, int k,
    int P, int P_pad, int canonical, int mask_amb, int seg, void* stream) {
  if (k < 1 || k > 31 || B < 1 || P < 1 || P_pad % seg != 0 ||
      (P_pad + CHUNK - 1) / CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS, (P_pad + CHUNK - 1) / CHUNK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (seg) {
    case 2: launch_seg<2>(grid, st, packed, canonical, codes, row_stride,
                          lengths, limits, keys, counts, B, L, k, P, P_pad,
                          mask_amb); break;
    case 4: launch_seg<4>(grid, st, packed, canonical, codes, row_stride,
                          lengths, limits, keys, counts, B, L, k, P, P_pad,
                          mask_amb); break;
    case 8: launch_seg<8>(grid, st, packed, canonical, codes, row_stride,
                          lengths, limits, keys, counts, B, L, k, P, P_pad,
                          mask_amb); break;
    case 16: launch_seg<16>(grid, st, packed, canonical, codes, row_stride,
                            lengths, limits, keys, counts, B, L, k, P, P_pad,
                            mask_amb); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
