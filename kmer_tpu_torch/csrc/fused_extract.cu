// Fused k-mer count step for Hopper (sm_90a): extraction, canonical key,
// validity, sentinel and the in-segment all-pairs collapse in one pass.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/fused_extract.py `_kernel`
// (entry fused_extract_count_T) and the collapse it inlines,
// kmer_tpu/ops/pallas/fused_count.py `_dedup_runlen`: contiguous keys of 1
// to 63 bases (the TPU kernel's doubling and banded-matmul extractions
// `_mxu_extract` and `_mxu_extract_shared`) and spaced seeds
// (`positions`).
//
// What bounds it: memory.  Each output lane costs an 8-byte key (16 for a
// (hi, lo) pair) and a 1-byte count store; the input is L/4 bytes of
// packed codes per row (L bytes for u8 rows); the arithmetic is a few
// integer ops per base, and for a spaced seed a rotate and a masked or per
// piece of its cut table.
//
// Design: one thread walks CHUNK consecutive window starts of one row,
// where the TPU kernel builds every window at once with O(log k) doubling
// tables or banded matmuls because its vector lanes carry no state along a
// sequence.  Two bodies (kmer_window.cuh): fused_extract_kernel for a
// contiguous window, which keeps a rolling forward value and a rolling
// reverse complement (Roll; 64-bit registers up to 31 bases, 128-bit
// beyond), each updated in O(1) per base, and for a spaced seed of span
// over 64, which gathers its n selected bases, O(n) loads a window from L1,
// the offsets broadcast from shared memory; fused_rolled_kernel for a
// spaced seed of span <= 64, which rolls its whole span the same way
// (SpanWalk) and cuts its key out of the registers by the seed's cut table
// (the mask's runs, cut into pieces that each lie in one 32-bit word of
// the span register and of the key: forward, and reverse complement with
// the same table), 4 windows at a time so that each load of a piece serves
// 8 independent cuts, with a rolled bit a base for ambiguity.  So a row is
// read once, one packed word every 16 bases, except by the gather, and
// don't-care bases poison no window.  Neighbouring threads take
// neighbouring rows, so a warp's store of keys[o, b .. b+31] is one
// contiguous 256-byte run: the output is position-major (P_pad, B), the
// TPU kernel's layout.  The collapse runs over the SEG keys of a segment
// held in registers, comparing both words of a pair; SEG is a template
// parameter, so the loops unroll and the register array is indexed
// statically.  Splitting each row into CHUNK-sized pieces (each primed with
// the n - 1 bases before it, span - 1 for a rolled span) gives
// ceil(P_pad / CHUNK) times more threads than one thread per row.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

constexpr int CHUNK = 32;      // window starts per thread; every SEG divides it
constexpr int THREADS = 128;

// count on the first occurrence: itself + equal keys later in the segment
// kh[t .. t + SEG) (windows s + t ..); later duplicates and sentinels get 0
template <int SEG, bool TWO, int N>
__device__ __forceinline__ void count_segment(const int64_t (&kh)[N],
                                              const int64_t (&kl)[N], int s,
                                              int t, int8_t* counts, int B,
                                              int b) {
#pragma unroll
  for (int i = t; i < t + SEG; ++i) {
    int cnt = 0;
    if (kh[i] != kmer::SENTINEL) {
      bool dup = false;
      cnt = 1;
#pragma unroll
      for (int j = t; j < t + SEG; ++j) {
        const bool eq = kh[j] == kh[i] && (!TWO || kl[j] == kl[i]);
        if (j < i) dup |= eq;
        if (j > i) cnt += eq;
      }
      if (dup) cnt = 0;
    }
    counts[(size_t)(s + i) * B + b] = (int8_t)cnt;
  }
}

// a contiguous key, or a spaced seed's gathered key (span over 64)
template <typename KEY, int SEG, bool PACKED, bool CANON, bool SPACED>
__global__ void __launch_bounds__(THREADS)
fused_extract_kernel(const void* __restrict__ codes, int row_stride,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ limits,
                     int64_t* __restrict__ keys_hi,
                     int64_t* __restrict__ keys_lo,
                     int8_t* __restrict__ counts, int B, int L, int n,
                     int span, int P, int P_pad, int mask_amb,
                     kmer::Offsets off) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  __shared__ int16_t pos[SPACED ? kmer::MAX_BASES : 1];
  if constexpr (SPACED) {
    if (threadIdx.x < n) pos[threadIdx.x] = off.at[threadIdx.x];
    __syncthreads();
  }
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int o0 = blockIdx.y * CHUNK;
  const int o_end = min(o0 + CHUNK, P_pad);
  // window o is valid iff o < P, o <= len - span, o < limit, no ambiguous
  // base among its key's bases
  const int o_hi = min(min(P, lengths[b] - span + 1), limits[b]);
  const void* row = static_cast<const char*>(codes) +
                    (size_t)b * row_stride * (PACKED ? 4 : 1);
  kmer::RowReader<PACKED> reader(row, L, mask_amb);
  kmer::Roll<KEY> roll(n);

  if constexpr (!SPACED)
    for (int q = o0; q < o0 + n - 1; ++q)
      roll.template push<CANON>(reader.next(q));
  for (int s = o0; s < o_end; s += SEG) {
    int64_t kh[SEG], kl[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      const int o = s + j;
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
      if (ok) {
        kmer::split_key(v, n, kh[j], kl[j]);
      } else {
        kh[j] = kl[j] = kmer::SENTINEL;
      }
      keys_hi[(size_t)o * B + b] = kh[j];
      if constexpr (TWO) keys_lo[(size_t)o * B + b] = kl[j];
    }
    count_segment<SEG, TWO>(kh, kl, s, 0, counts, B, b);
  }
}

// a spaced seed of span <= 64: the rolled span cut by the seed's table
template <typename KEY, typename SPAN, int SEG, bool PACKED, bool CANON>
__global__ void __launch_bounds__(THREADS)
fused_rolled_kernel(const void* __restrict__ codes, int row_stride,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ limits,
                    int64_t* __restrict__ keys_hi,
                    int64_t* __restrict__ keys_lo,
                    int8_t* __restrict__ counts, int B, int L, int n,
                    int span, int P, int P_pad, int mask_amb, kmer::Cut cut) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  __shared__ kmer::Cut cut_sh;
  kmer::load_cut(cut_sh, cut);
  __syncthreads();
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int o0 = blockIdx.y * CHUNK;
  const int o_end = min(o0 + CHUNK, P_pad);
  // window o is valid iff o < P, o <= len - span, o < limit, no ambiguous
  // base at a selected offset
  const int o_hi = min(min(P, lengths[b] - span + 1), limits[b]);
  const void* row = static_cast<const char*>(codes) +
                    (size_t)b * row_stride * (PACKED ? 4 : 1);
  typedef kmer::SpanWalk<KEY, SPAN, PACKED, CANON> Walk;
  Walk win(row, L, span, mask_amb, cut_sh);
  win.prime(o0);
  // a step is one segment, or the Walk::G windows whose keys are cut at
  // once when they span more than one (STEP divides CHUNK; o_end is a
  // multiple of SEG, so a segment lies wholly before or after it)
  constexpr int G = Walk::G, STEP = SEG > G ? SEG : G;
  for (int s = o0; s < o_end; s += STEP) {
    int64_t kh[STEP], kl[STEP];
#pragma unroll
    for (int j0 = 0; j0 < STEP; j0 += G) {
      bool ok[G];
      KEY v[G];
#pragma unroll
      for (int j = 0; j < G; ++j) ok[j] = s + j0 + j < o_hi;
      win.keys(s + j0, ok, v);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int i = j0 + j, o = s + i;
        if (ok[j]) {
          kmer::split_key(v[j], n, kh[i], kl[i]);
        } else {
          kh[i] = kl[i] = kmer::SENTINEL;
        }
        if (STEP == SEG || o < o_end) {
          keys_hi[(size_t)o * B + b] = kh[i];
          if constexpr (TWO) keys_lo[(size_t)o * B + b] = kl[i];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < STEP; t += SEG)
      if (STEP == SEG || s + t < o_end)
        count_segment<SEG, TWO>(kh, kl, s, t, counts, B, b);
  }
}

// one batch's launch arguments; kmer::dispatch picks the template
// arguments of run or rolled, and they the segment width
struct Launch {
  dim3 grid;
  cudaStream_t st;
  const void* codes;
  int row_stride;
  const int32_t *lengths, *limits;
  int64_t *keys_hi, *keys_lo;
  int8_t* counts;
  int B, L, n, span, P, P_pad, mask_amb, seg;
  kmer::Offsets off;
  kmer::Cut cut;

  template <typename KEY, int SEG, bool PACKED, bool CANON, bool SPACED>
  void go() const {
    fused_extract_kernel<KEY, SEG, PACKED, CANON, SPACED>
        <<<grid, THREADS, 0, st>>>(codes, row_stride, lengths, limits,
                                   keys_hi, keys_lo, counts, B, L, n, span,
                                   P, P_pad, mask_amb, off);
  }
  template <typename KEY, bool PACKED, bool CANON, bool SPACED>
  void run() const {
    switch (seg) {
      case 2: go<KEY, 2, PACKED, CANON, SPACED>(); break;
      case 4: go<KEY, 4, PACKED, CANON, SPACED>(); break;
      case 8: go<KEY, 8, PACKED, CANON, SPACED>(); break;
      case 16: go<KEY, 16, PACKED, CANON, SPACED>(); break;
    }
  }
  template <typename KEY, typename SPAN, int SEG, bool PACKED, bool CANON>
  void go_rolled() const {
    fused_rolled_kernel<KEY, SPAN, SEG, PACKED, CANON>
        <<<grid, THREADS, 0, st>>>(codes, row_stride, lengths, limits,
                                   keys_hi, keys_lo, counts, B, L, n, span,
                                   P, P_pad, mask_amb, cut);
  }
  template <typename KEY, typename SPAN, bool PACKED, bool CANON>
  void rolled() const {
    switch (seg) {
      case 2: go_rolled<KEY, SPAN, 2, PACKED, CANON>(); break;
      case 4: go_rolled<KEY, SPAN, 4, PACKED, CANON>(); break;
      case 8: go_rolled<KEY, SPAN, 8, PACKED, CANON>(); break;
      case 16: go_rolled<KEY, SPAN, 16, PACKED, CANON>(); break;
    }
  }
};

}  // namespace

// codes: (B, row_stride) int32 words of 16 packed bases (packed != 0) or
// (B, row_stride) uint8 codes (code >= 4 ambiguous); lengths/limits: (B,)
// int32.  A key of n bases: contiguous (positions == nullptr, span = n) or
// a spaced seed's bases at window offsets positions[0 .. n) (host memory,
// checked by the caller: ascending, positions[0] = 0, span = positions[n -
// 1] + 1) with, for a span of at most 64 bases, its cut table `cut` of
// kmer::CUT_TABLE_WORDS words (ops/extract.seed_cut_table).  keys_hi:
// (P_pad, B) int64, the key for n <= 31, else the hi word of the pair whose
// lo word is keys_lo, (P_pad, B) int64 (unused for n <= 31); counts:
// (P_pad, B) int8; seg 2, 4, 8 or 16 divides P_pad.  Returns the launch's
// cudaError_t.
extern "C" int fused_extract_count_launch(
    const void* codes, int packed, int row_stride, const int32_t* lengths,
    const int32_t* limits, int64_t* keys_hi, int64_t* keys_lo, int8_t* counts,
    int B, int L, int n, int span, int P, int P_pad, int canonical,
    int mask_amb, int seg, const int32_t* positions, const uint32_t* cut,
    void* stream) {
  const bool rolled = positions != nullptr && span <= kmer::MAX_ROLLED_SPAN;
  if (n < 1 || n > kmer::MAX_BASES || B < 1 || P < 1 || P != L - span + 1 ||
      (seg != 2 && seg != 4 && seg != 8 && seg != 16) || P_pad % seg != 0 ||
      (P_pad + CHUNK - 1) / CHUNK > 65535 ||
      (positions == nullptr && span != n) || (rolled && cut == nullptr) ||
      (n > kmer::HI_BASES && keys_lo == nullptr))
    return (int)cudaErrorInvalidValue;
  const Launch l = {
      dim3((B + THREADS - 1) / THREADS, (P_pad + CHUNK - 1) / CHUNK),
      static_cast<cudaStream_t>(stream), codes, row_stride, lengths, limits,
      keys_hi, keys_lo, counts, B, L, n, span, P, P_pad, mask_amb, seg,
      kmer::offsets_of(positions, n), kmer::cut_of(rolled ? cut : nullptr)};
  kmer::dispatch(l, n, packed, canonical, positions != nullptr, span);
  return (int)cudaGetLastError();
}

// the cut table's layout (kmer::cut_layout): CUT_WORDS, CUT_TABLE_WORDS,
// MAX_ROLLED_SPAN
extern "C" void cut_layout(int32_t* out) { kmer::cut_layout(out); }
