// Fused k-mer count step for Hopper (sm_90a): extraction, canonical key,
// validity, sentinel and the in-segment all-pairs collapse in one pass.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/fused_extract.py `_kernel`
// (pallas_call at :789, entry fused_extract_count_T :672) and the
// collapse it inlines, kmer_tpu/ops/pallas/fused_count.py `_dedup_runlen`:
// contiguous keys of 1 to 63 bases (the TPU kernel's doubling and
// banded-matmul extractions `_mxu_extract` and `_mxu_extract_shared`) and
// spaced seeds (`positions`).
//
// What bounds it: memory, and there the key stores.  Each output lane
// costs an 8-byte key (16 for a (hi, lo) pair) and a 1-byte count store;
// the input is L/4 bytes of packed codes per row (L bytes for u8 rows);
// the arithmetic is a few integer ops a key.
//
// Design: the TPU kernel builds every window at once with O(log k)
// doubling tables or banded matmuls because its vector lanes carry no
// state along a sequence.  Here three bodies (kmer_window.cuh):
// - fused_cut_kernel, a contiguous key: a block is a tile of 32 rows (the
//   lanes of a warp) and a run of windows (RUN a warp); it stages the
//   rows' packed words that the run covers and, for u8 rows with the
//   ambiguity mask, their ambiguity words in shared memory in one pass
//   (CutTile), and each thread cuts the keys of its row's RUN windows
//   straight out of the tile: a few funnel shifts a key and, canonical, a
//   bit reverse of the cut for its reverse complement, with no priming.
//   RUN = max(SEG, 8): on an H100, 8 windows a thread measured faster
//   than 4 (a thread for each of the card's thread slots at the main
//   path's batch) and than 16 (PERF.md); the main path's 8192 rows of 160
//   bases launch 768 blocks of 192 threads, one wave;
// - fused_rolled_kernel, a spaced seed of span <= 64: one thread walks
//   CHUNK windows of one row, rolls the whole span (SpanWalk), primed
//   with span - 1 bases, and cuts its key out of the registers by the
//   seed's cut table (the mask's runs, cut into pieces that each lie in
//   one 32-bit word of the span register and of the key: forward, and
//   reverse complement with the same table), 4 windows at a time so that
//   each load of a piece serves 8 independent cuts, with a rolled bit a
//   base for ambiguity, so that don't-care bases poison no window;
// - fused_gather_kernel, a spaced seed of span over 64: one thread walks
//   CHUNK windows of one row and gathers each window's n selected bases,
//   O(n) loads a window from L1, the offsets broadcast from shared memory.
// Neighbouring threads take neighbouring rows, so a warp's store of
// keys[o, b .. b+31] is one contiguous 256-byte run: the output is
// position-major (P_pad, B), the TPU kernel's layout.  The collapse runs
// over the SEG keys of a segment held in registers, comparing both words
// of a pair; SEG is a template parameter, so the loops unroll and the
// register array is indexed statically.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

// the rolled and gathered bodies: window starts a thread (every SEG
// divides it) and threads a block
constexpr int CHUNK = 32;
constexpr int THREADS = 128;
// the cut body: rows a tile (a warp's lanes), its fewest windows a thread
// (RUN = max(SEG, MIN_RUN)) and most warps a block
constexpr int ROWS = 32, MIN_RUN = 8, MAX_WARPS = 8;

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

// a contiguous key cut out of the block's tile
template <typename KEY, int SEG, bool PACKED, bool CANON>
__global__ void __launch_bounds__(ROWS * MAX_WARPS)
fused_cut_kernel(const void* __restrict__ codes, int row_stride,
                 const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ limits,
                 int64_t* __restrict__ keys_hi, int64_t* __restrict__ keys_lo,
                 int8_t* __restrict__ counts, int B, int L, int n, int P,
                 int P_pad, int mask_amb, int cap, int stride) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  constexpr int RUN = SEG > MIN_RUN ? SEG : MIN_RUN;
  extern __shared__ uint32_t tile_sm[];
  // block = (window tile, row group), the row groups of a tile adjacent
  const int groups = (B + ROWS - 1) / ROWS;
  const int b0 = blockIdx.x % groups * ROWS;
  const int warps = blockDim.x / 32;
  // o0 < P: o0 is a multiple of SEG below P_pad, and P_pad - P < SEG
  const int o0 = blockIdx.x / groups * warps * RUN;
  const kmer::CutTile tile = {tile_sm, cap, stride, n, (L + 15) / 16,
                              !PACKED && mask_amb != 0};
  tile.stage<PACKED>(codes, row_stride, L, b0, min(ROWS, B - b0),
                     [=](int) { return o0; });
  const int lane = threadIdx.x & 31;
  const int b = b0 + lane, s0 = o0 + (threadIdx.x >> 5) * RUN;
  if (b >= B || s0 >= P_pad) return;
  // window o is valid iff o < P, o <= len - n, o < limit, no ambiguous
  // base among its bases; a padded window (P <= o < P_pad) is cut at P - 1
  const int o_hi = min(min(P, lengths[b] - n + 1), limits[b]);
#pragma unroll
  for (int r = 0; r < RUN; r += SEG) {
    const int s = s0 + r;
    if (RUN > SEG && s >= P_pad) break;
    int64_t kh[SEG], kl[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      const int o = s + j, oc = min(o, P - 1);
      bool ok = o < o_hi;
      tile.key<TWO, CANON>(lane, oc, o0, kh[j], kl[j]);
      if (!PACKED && mask_amb) ok = ok && !tile.ambiguous<TWO>(lane, oc, o0);
      if (!ok) kh[j] = kl[j] = kmer::SENTINEL;
      keys_hi[(size_t)o * B + b] = kh[j];
      if constexpr (TWO) keys_lo[(size_t)o * B + b] = kl[j];
    }
    count_segment<SEG, TWO>(kh, kl, s, 0, counts, B, b);
  }
}

// a spaced seed of span over 64: the gathered key
template <typename KEY, int SEG, bool PACKED, bool CANON>
__global__ void __launch_bounds__(THREADS)
fused_gather_kernel(const void* __restrict__ codes, int row_stride,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ limits,
                    int64_t* __restrict__ keys_hi,
                    int64_t* __restrict__ keys_lo,
                    int8_t* __restrict__ counts, int B, int L, int n,
                    int span, int P, int P_pad, int mask_amb,
                    kmer::Offsets off) {
  constexpr bool TWO = kmer::TWO_WORDS<KEY>;
  __shared__ int16_t pos[kmer::MAX_BASES];
  if (threadIdx.x < n) pos[threadIdx.x] = off.at[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int o0 = blockIdx.y * CHUNK;
  const int o_end = min(o0 + CHUNK, P_pad);
  // window o is valid iff o < P, o <= len - span, o < limit, no ambiguous
  // base among its key's bases
  const int o_hi = min(min(P, lengths[b] - span + 1), limits[b]);
  const void* row = static_cast<const char*>(codes) +
                    (size_t)b * row_stride * (PACKED ? 4 : 1);
  for (int s = o0; s < o_end; s += SEG) {
    int64_t kh[SEG], kl[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      const int o = s + j;
      bool ok = o < o_hi;
      KEY v;
      bool amb;
      v = kmer::gather_key<KEY, PACKED, CANON>(row, o, pos, n, L, amb);
      ok = ok && !(mask_amb && amb);
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

// one batch's launch arguments; kmer::dispatch picks the body and its
// template arguments, and they the segment width.  With `info`, each body
// reports its launch (kmer::report) instead of making it.
struct Launch {
  cudaStream_t st;
  const void* codes;
  int row_stride;
  const int32_t *lengths, *limits;
  int64_t *keys_hi, *keys_lo;
  int8_t* counts;
  int B, L, n, span, P, P_pad, mask_amb, seg;
  kmer::Offsets off;
  kmer::Cut cut;
  int* info;

  template <typename K, typename... A>
  void launch(K kernel, dim3 grid, int threads, size_t smem,
              A... args) const {
    if (info)
      kmer::report(info, kernel, grid.x * grid.y, threads, smem);
    else
      kernel<<<grid, threads, smem, st>>>(args...);
  }
  // the rolled and gathered bodies: a thread a row and CHUNK windows
  dim3 row_grid() const {
    return dim3((B + THREADS - 1) / THREADS, (P_pad + CHUNK - 1) / CHUNK);
  }
  // the cut body: tiles of ROWS rows by `warps` runs of RUN windows, as
  // few tiles a row group as MAX_WARPS allows, their warps evened out
  template <typename KEY, int SEG, bool PACKED, bool CANON>
  void go_cut() const {
    constexpr int RUN = SEG > MIN_RUN ? SEG : MIN_RUN;
    const int runs = (P_pad + RUN - 1) / RUN;
    const int tiles = (runs + MAX_WARPS - 1) / MAX_WARPS;
    const int warps = (runs + tiles - 1) / tiles;
    int cap, stride;
    kmer::tile_shape(warps * RUN, n, !PACKED && mask_amb, cap, stride);
    launch(fused_cut_kernel<KEY, SEG, PACKED, CANON>,
           dim3((unsigned)tiles * ((B + ROWS - 1) / ROWS)), ROWS * warps,
           (size_t)ROWS * stride * 4, codes, row_stride, lengths, limits,
           keys_hi, keys_lo, counts, B, L, n, P, P_pad, mask_amb, cap,
           stride);
  }
  template <typename KEY, bool PACKED, bool CANON>
  void contiguous() const {
    switch (seg) {
      case 2: go_cut<KEY, 2, PACKED, CANON>(); break;
      case 4: go_cut<KEY, 4, PACKED, CANON>(); break;
      case 8: go_cut<KEY, 8, PACKED, CANON>(); break;
      case 16: go_cut<KEY, 16, PACKED, CANON>(); break;
    }
  }
  template <typename KEY, int SEG, bool PACKED, bool CANON>
  void go_gather() const {
    launch(fused_gather_kernel<KEY, SEG, PACKED, CANON>, row_grid(), THREADS,
           0, codes, row_stride, lengths, limits, keys_hi, keys_lo, counts,
           B, L, n, span, P, P_pad, mask_amb, off);
  }
  template <typename KEY, bool PACKED, bool CANON>
  void gather() const {
    switch (seg) {
      case 2: go_gather<KEY, 2, PACKED, CANON>(); break;
      case 4: go_gather<KEY, 4, PACKED, CANON>(); break;
      case 8: go_gather<KEY, 8, PACKED, CANON>(); break;
      case 16: go_gather<KEY, 16, PACKED, CANON>(); break;
    }
  }
  template <typename KEY, typename SPAN, int SEG, bool PACKED, bool CANON>
  void go_rolled() const {
    launch(fused_rolled_kernel<KEY, SPAN, SEG, PACKED, CANON>, row_grid(),
           THREADS, 0, codes, row_stride, lengths, limits, keys_hi, keys_lo,
           counts, B, L, n, span, P, P_pad, mask_amb, cut);
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

// the launch (info == nullptr) or its report
int launch_or_report(const void* codes, int packed, int row_stride,
                     const int32_t* lengths, const int32_t* limits,
                     int64_t* keys_hi, int64_t* keys_lo, int8_t* counts,
                     int B, int L, int n, int span, int P, int P_pad,
                     int canonical, int mask_amb, int seg,
                     const int32_t* positions, const uint32_t* cut,
                     void* stream, int* info) {
  const bool spaced = positions != nullptr;
  const bool rolled = spaced && span <= kmer::MAX_ROLLED_SPAN;
  // the cut body's most blocks: at least MIN_RUN windows a warp
  const int64_t cut_blocks =
      (int64_t)((P_pad + MIN_RUN * MAX_WARPS - 1) / (MIN_RUN * MAX_WARPS)) *
      ((B + ROWS - 1) / ROWS);
  if (n < 1 || n > kmer::MAX_BASES || B < 1 || P < 1 || P != L - span + 1 ||
      (seg != 2 && seg != 4 && seg != 8 && seg != 16) || P_pad % seg != 0 ||
      P_pad < P || P_pad - P >= seg ||
      (spaced && (P_pad + CHUNK - 1) / CHUNK > 65535) ||
      (!spaced && cut_blocks > 0x7FFFFFFF) ||
      (!spaced && span != n) || (rolled && cut == nullptr) ||
      (n > kmer::HI_BASES && keys_lo == nullptr) ||
      (packed && row_stride < (L + 15) / 16) || (!packed && row_stride < L))
    return (int)cudaErrorInvalidValue;
  const Launch l = {static_cast<cudaStream_t>(stream), codes, row_stride,
                    lengths, limits, keys_hi, keys_lo, counts, B, L, n, span,
                    P, P_pad, mask_amb, seg, kmer::offsets_of(positions, n),
                    kmer::cut_of(rolled ? cut : nullptr), info};
  kmer::dispatch(l, n, packed, canonical, spaced, span);
  return info ? info[kmer::INFO_INTS - 1] : (int)cudaGetLastError();
}

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
// (P_pad, B) int8; seg 2, 4, 8 or 16 divides P_pad, the least multiple of
// seg at or above P.  Returns the launch's cudaError_t.
extern "C" int fused_extract_count_launch(
    const void* codes, int packed, int row_stride, const int32_t* lengths,
    const int32_t* limits, int64_t* keys_hi, int64_t* keys_lo, int8_t* counts,
    int B, int L, int n, int span, int P, int P_pad, int canonical,
    int mask_amb, int seg, const int32_t* positions, const uint32_t* cut,
    void* stream) {
  return launch_or_report(codes, packed, row_stride, lengths, limits,
                          keys_hi, keys_lo, counts, B, L, n, span, P, P_pad,
                          canonical, mask_amb, seg, positions, cut, stream,
                          nullptr);
}

// the launch that fused_extract_count_launch would make with the same
// arguments (no pointer is read), reported into info[0 .. 7) as
// kmer::report lays it out; returns the cudaError_t of the queries
extern "C" int fused_extract_count_info(
    int packed, int row_stride, int B, int L, int n, int span, int P,
    int P_pad, int canonical, int mask_amb, int seg,
    const int32_t* positions, const uint32_t* cut, int* info) {
  int64_t dummy[1];
  return launch_or_report(nullptr, packed, row_stride, nullptr, nullptr,
                          dummy, dummy, nullptr, B, L, n, span, P, P_pad,
                          canonical, mask_amb, seg, positions, cut, nullptr,
                          info);
}

// the cut table's layout (kmer::cut_layout): CUT_WORDS, CUT_TABLE_WORDS,
// MAX_ROLLED_SPAN
extern "C" void cut_layout(int32_t* out) { kmer::cut_layout(out); }
