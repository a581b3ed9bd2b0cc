// Window extraction shared by csrc/fused_extract.cu (K1) and
// csrc/extract.cu (K7): the tile of a contiguous window and the cut of its
// key, the row reader, the rolled span of a spaced seed and the cut of its
// key, the gathered key of a wide spaced seed, the key's int64 words, and
// the host dispatch from runtime choices to a kernel's template arguments.
//
// A key of n bases leaves the kernel in the layout of
// kmer_tpu_torch/ops/encode.py: one int64 for n <= 31; for 32 <= n <= 63
// the pair (hi, lo), hi the value of the first 31 bases and lo that of the
// last n - 31, with lo's top bit flipped when lo holds 32 bases (64 bits),
// so that signed int64 order on lo is the order of its bits.  A real hi is
// at most 62 bits and never equals SENTINEL.  The KEY template argument is
// uint64_t for n <= 31 and an unsigned __int128 beyond: the register of a
// rolled or gathered key, and for a contiguous key only the choice of one
// word or two.
//
// The windows:
// - a contiguous k-mer (CutTile, the kernels' cut bodies): a block stages
//   the rows it serves in shared memory, each row's segment as packed
//   words (16 bases a word, the first base in the top pair; u8 codes
//   packed by their low two bits) and, for u8 rows with the ambiguity
//   mask, an ambiguity row in the same layout (01 a base whose code is
//   >= 4).  The forward key of window o is then bits [2o, 2o + 2n) of the
//   row's stream: a handful of __funnelshift_l a 64-bit cut, whatever n
//   is, with no priming; its reverse complement is the reverse complement
//   of forward cuts (rc64: a bit reverse, a swap within each 2-bit pair
//   and a complement).  A pair is cut as hi (31 bases from o) and lo
//   (n - 31 bases from o + 31) and compared as (hi, lo) before lo's top
//   bit is flipped; a window is ambiguous iff its cut of the ambiguity row
//   is not zero;
// - a spaced seed of span <= 64 (the kernels' rolled body, SpanWalk): the
//   window's whole span rolled one base at a time (SpanRoll: a uint64_t
//   register up to 32 bases when the key is one word, else 128 bits, held
//   as 32-bit words), and the key cut out of it by the seed's cut table
//   (ops/extract.seed_cut_table): the mask's runs of consecutive '1's,
//   split so that each piece lies in one 32-bit word of the span register
//   and one of the key; a piece is a rotate and a masked or.  The canonical
//   key is cut from the reverse-complement register with the same table.
//   That is right only because a canonical mask is a palindrome
//   (ops/extract.check_window): the reverse complement of the span then
//   selects the same offsets, in reverse order, complemented.  A
//   non-canonical mask need not be one; only its forward key is cut.  With
//   the ambiguity mask, a 64-bit register rolls one "ambiguous" bit a base,
//   and a window is invalid iff it shares a bit with the table's selection
//   mask, so an ambiguous base at a don't-care offset never poisons a
//   window;
// - a spaced seed of span over 64, where a span register would not fit:
//   the n selected bases loaded one by one from the offsets in shared
//   memory (gather_key), in the kernels' gather bodies.
//
// The build helper (kmer_tpu_torch/utils/build.py) rebuilds a kernel when
// this header is newer than its library.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmer {

typedef unsigned __int128 u128;

constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;
constexpr int HI_BASES = 31;     // bases of one int64 key word
constexpr int MAX_BASES = 63;    // bases of a (hi, lo) pair
constexpr int MAX_ROLLED_SPAN = 64;

// true when KEY is the 128-bit register of a (hi, lo) pair
template <typename KEY>
constexpr bool TWO_WORDS = sizeof(KEY) > sizeof(uint64_t);

// a spaced seed's window offsets (ascending, at[0] = 0; checked by the
// caller), passed by value as a kernel parameter; a block copies them to
// shared memory
struct Offsets {
  int16_t at[MAX_BASES];
};

inline Offsets offsets_of(const int32_t* positions, int n) {
  Offsets off = {};
  for (int i = 0; positions != nullptr && i < n; ++i)
    off.at[i] = (int16_t)positions[i];
  return off;
}

// A spaced seed's cut table, as ops/extract.seed_cut_table lays it out in
// CUT_TABLE_WORDS uint32 words: the start of each group (CUT_GROUPS + 1),
// then (mask, rot) for each of at most MAX_BASES pieces, then the 64-bit
// selection mask (low word first).  Group g = source word * CUT_WORDS + key
// word holds the pieces [start[g], start[g + 1]); a piece ors
// rotr(source word, rot) & mask into its key word.  Passed by value as a
// kernel parameter; a block copies it to shared memory.  The wrappers check
// their copy of the layout against cut_layout (the kernels' C entry points)
// when they load a library.
constexpr int CUT_WORDS = 4;
constexpr int CUT_GROUPS = CUT_WORDS * CUT_WORDS;
constexpr int CUT_TABLE_WORDS = CUT_GROUPS + 1 + 2 * MAX_BASES + 2;

struct Piece {
  uint32_t mask, rot;
};

struct Cut {
  uint8_t start[CUT_GROUPS + 1];
  Piece piece[MAX_BASES];
  uint64_t amb;   // bit span - 1 - i for each selected offset i
};

inline Cut cut_of(const uint32_t* table) {
  Cut cut = {};
  if (table == nullptr) return cut;
  for (int g = 0; g <= CUT_GROUPS; ++g) cut.start[g] = (uint8_t)table[g];
  const uint32_t* p = table + CUT_GROUPS + 1;
  for (int i = 0; i < MAX_BASES; ++i) cut.piece[i] = {p[2 * i], p[2 * i + 1]};
  p += 2 * MAX_BASES;
  cut.amb = p[0] | (uint64_t)p[1] << 32;
  return cut;
}

// a block's copy of the cut table in shared memory (the caller syncs)
__device__ __forceinline__ void load_cut(Cut& sh, const Cut& cut) {
  for (int i = threadIdx.x; i < MAX_BASES; i += blockDim.x)
    sh.piece[i] = cut.piece[i];
  for (int g = threadIdx.x; g <= CUT_GROUPS; g += blockDim.x)
    sh.start[g] = cut.start[g];
  if (threadIdx.x == 0) sh.amb = cut.amb;
}

// code of base q of a row: 2-bit packed (16 bases an int32 word, the
// first base in the top pair) or one uint8 a base (>= 4 ambiguous); 0 past
// the row's width L
template <bool PACKED>
__device__ __forceinline__ uint32_t code_at(const void* row, int q, int L) {
  if (q >= L) return 0u;
  if constexpr (PACKED) {
    const uint32_t w = __ldg(static_cast<const uint32_t*>(row) + (q >> 4));
    return (w >> (30 - 2 * (q & 15))) & 3u;
  } else {
    return __ldg(static_cast<const uint8_t*>(row) + q);
  }
}

// One row's codes read in order (q runs up from a multiple of 16), a
// packed row one int32 word every 16 bases: the 2-bit code of base q, 0
// past the row's width L.  An ambiguous u8 code (>= 4) reads as its low
// two bits and, with mask_amb, sets last_amb to q.
template <bool PACKED>
struct RowReader {
  const void* row;
  int L;
  bool mask_amb;
  int last_amb = -1;
  uint32_t word = 0;
  __device__ RowReader(const void* row_, int L_, bool mask_amb_)
      : row(row_), L(L_), mask_amb(mask_amb_) {}
  __device__ __forceinline__ uint32_t next(int q) {
    if (q >= L) return 0u;
    if constexpr (PACKED) {
      if ((q & 15) == 0)
        word = __ldg(static_cast<const uint32_t*>(row) + (q >> 4));
      return (word >> (30 - 2 * (q & 15))) & 3u;
    } else {
      uint32_t c = __ldg(static_cast<const uint8_t*>(row) + q);
      if (c >= 4u) {
        if (mask_amb) last_amb = q;
        c &= 3u;
      }
      return c;
    }
  }
};

// The key of the n bases at o + off[i] of a row (off in shared memory),
// O(n) loads; amb is set when one of them is ambiguous (u8 rows).  With
// CANON the min of the key and the reverse complement of its bases (base
// i complemented to position n - 1 - i): the strand-min of a window whose
// mask is a palindrome.
template <typename KEY, bool PACKED, bool CANON>
__device__ __forceinline__ KEY gather_key(const void* row, int o,
                                          const int16_t* off, int n, int L,
                                          bool& amb) {
  KEY v = 0, rc = 0;
  bool bad = false;
  for (int i = 0; i < n; ++i) {
    uint32_t c = code_at<PACKED>(row, o + off[i], L);
    bad |= c >= 4u;
    c &= 3u;
    v = (v << 2) | c;
    if constexpr (CANON) rc |= (KEY)(3u - c) << (2 * i);
  }
  amb = bad;
  if constexpr (CANON) v = rc < v ? rc : v;
  return v;
}

// A spaced seed's span of at most 64 bases rolled one base at a time, in
// W 32-bit words (word 0 the lowest): the forward value, base i of the
// window at bit 2 (span - 1 - i) (older bases above the span are never
// cut, so nothing masks them off), and the reverse complement, the
// complement of base i at bit 2 i, entered at bit 2 span - 2 (unit holds
// that bit, so the complement enters by one multiply-add a word; the bits
// above the span stay 0).  No shift reaches the register's width, so a
// span of exactly 32 or 64 bases needs no special case.
template <typename SPAN>
struct SpanRoll {
  static constexpr int W = sizeof(SPAN) / 4;
  uint32_t fw[W], rc[W], unit[W];
  uint64_t amb = 0;   // bit span - 1 - i: base i of the window is ambiguous
  __device__ explicit SpanRoll(int span) {
    const int top = 2 * span - 2;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      fw[w] = rc[w] = 0u;
      unit[w] = (top >> 5) == w ? 1u << (top & 31) : 0u;
    }
  }
  template <bool CANON>
  __device__ __forceinline__ void push(uint32_t c) {
#pragma unroll
    for (int w = W - 1; w > 0; --w)
      fw[w] = __funnelshift_l(fw[w - 1], fw[w], 2);
    fw[0] = (fw[0] << 2) | c;
    if constexpr (CANON) {
      const uint32_t cc = 3u - c;
#pragma unroll
      for (int w = 0; w < W - 1; ++w)
        rc[w] = __funnelshift_r(rc[w], rc[w + 1], 2) + unit[w] * cc;
      rc[W - 1] = (rc[W - 1] >> 2) + unit[W - 1] * cc;
    }
  }
};

// The keys of G windows cut out of their span registers' words (f, r:
// the forward and reverse-complement registers after each window's push)
// by the cut table: each piece, loaded once for all G windows, a rotate and
// a masked or into its key word, so the G windows give 2 G independent
// chains; start holds the table's group starts in registers.  With CANON
// the min of the forward key and the key cut from the reverse complement.
template <typename KEY, int SW, bool CANON, int G>
__device__ __forceinline__ void cut_keys(const uint32_t (&f)[G][SW],
                                         const uint32_t (&r)[G][SW],
                                         const Piece* piece,
                                         const int (&start)[CUT_GROUPS + 1],
                                         KEY (&v)[G]) {
  constexpr int KW = sizeof(KEY) / 4;
  uint32_t kf[G][KW], kr[G][KW];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int w = 0; w < KW; ++w) kf[j][w] = kr[j][w] = 0u;
#pragma unroll
  for (int sw = 0; sw < SW; ++sw) {
#pragma unroll
    for (int dw = 0; dw <= sw && dw < KW; ++dw) {
      const int g = sw * CUT_WORDS + dw;
#pragma unroll 2
      for (int i = start[g]; i < start[g + 1]; ++i) {
        const Piece p = piece[i];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          kf[j][dw] |= __funnelshift_r(f[j][sw], f[j][sw], p.rot) & p.mask;
          if constexpr (CANON)
            kr[j][dw] |= __funnelshift_r(r[j][sw], r[j][sw], p.rot) & p.mask;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    KEY a = 0, c = 0;
#pragma unroll
    for (int w = KW - 1; w >= 0; --w) {
      a = (a << 32) | kf[j][w];
      if constexpr (CANON) c = (c << 32) | kr[j][w];
    }
    if constexpr (CANON) a = c < a ? c : a;
    v[j] = a;
  }
}

// One thread's walk over consecutive window starts of one row for a spaced
// seed of span <= 64 (cut: the block's copy in shared memory): prime(o0)
// reads the span - 1 bases before the first window o0 (o0 a multiple of
// 16), then keys(o, ok, v) gives the keys of the G windows o .. o + G - 1
// (each call's o the last call's o + G), which share each load of the cut
// table, and clears ok[j] when window o + j holds an ambiguous base at a
// selected offset (with mask_amb).
template <typename KEY, typename SPAN, bool PACKED, bool CANON>
struct SpanWalk {
  static constexpr int G = 4;
  RowReader<PACKED> reader;
  SpanRoll<SPAN> sr;
  const Cut& cut;
  int span;
  bool mask_amb;
  int start[CUT_GROUPS + 1];

  __device__ SpanWalk(const void* row, int L, int span_, bool mask_amb_,
                      const Cut& cut_)
      : reader(row, L, mask_amb_), sr(span_), cut(cut_), span(span_),
        mask_amb(mask_amb_) {
#pragma unroll
    for (int g = 0; g <= CUT_GROUPS; ++g) start[g] = cut.start[g];
  }

  __device__ __forceinline__ void push(int q) {
    sr.template push<CANON>(reader.next(q));
    if constexpr (!PACKED)
      if (mask_amb) sr.amb = (sr.amb << 1) | (uint64_t)(reader.last_amb == q);
  }

  __device__ __forceinline__ void prime(int o0) {
    for (int q = o0; q < o0 + span - 1; ++q) push(q);
  }

  __device__ __forceinline__ void keys(int o, bool (&ok)[G], KEY (&v)[G]) {
    constexpr int SW = SpanRoll<SPAN>::W;
    uint32_t f[G][SW], r[G][SW];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      push(o + j + span - 1);
#pragma unroll
      for (int w = 0; w < SW; ++w) {
        f[j][w] = sr.fw[w];
        r[j][w] = sr.rc[w];
      }
      if constexpr (!PACKED) ok[j] = ok[j] && (sr.amb & cut.amb) == 0;
    }
    cut_keys<KEY, SW, CANON, G>(f, r, cut.piece, start, v);
  }
};

// a key's value -> its words: the int64 key for n <= 31 (lo 0); else the
// (hi, lo) pair, lo flipped at 32 lo bases
template <typename KEY>
__device__ __forceinline__ void split_key(KEY v, int n, int64_t& hi,
                                          int64_t& lo) {
  if constexpr (!TWO_WORDS<KEY>) {
    hi = (int64_t)v;
    lo = 0;
  } else {
    const int s = 2 * (n - HI_BASES);
    uint64_t l = (uint64_t)v;
    if (s < 64)
      l &= (1ull << s) - 1ull;
    else
      l ^= 1ull << 63;
    hi = (int64_t)(uint64_t)(v >> s);
    lo = (int64_t)l;
  }
}

// ---- A contiguous window: the key cut out of a shared-memory tile ----

// the 64 bits of a packed stream from base q on (q >= 0 local to the words
// w, which hold at least (q >> 4) + 3 words)
__device__ __forceinline__ uint64_t cut64(const uint32_t* w, int q) {
  const int j = q >> 4, s = 2 * (q & 15);
  const uint32_t a = w[j], b = w[j + 1], c = w[j + 2];
  return (uint64_t)__funnelshift_l(b, a, s) << 32 | __funnelshift_l(c, b, s);
}

// four u8 codes (the first in the low byte, each <= 3) -> 8 packed bits,
// the first code on top
__device__ __forceinline__ uint32_t pack4(uint32_t y) {
  return (y & 0xFFu) << 6 | (y >> 8 & 0xFFu) << 4 | (y >> 16 & 0xFFu) << 2 |
         y >> 24;
}

// packed word j of a row (j < ceil(L / 16)): a packed row's int32 word, or
// a u8 row's bases 16 j .. 16 j + 15 packed by their low two bits, with
// their ambiguity word in `amb` (01 a base whose code is >= 4); bases past
// L are 0 in both
template <bool PACKED>
__device__ __forceinline__ uint32_t row_word(const void* row, int j, int L,
                                             uint32_t& amb) {
  amb = 0u;
  if constexpr (PACKED) {
    return __ldg(static_cast<const uint32_t*>(row) + j);
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(row) + 16 * j;
    uint32_t w = 0u;
    if (16 * j + 16 <= L && (reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
        w = w << 8 | pack4(x & 0x03030303u);
        amb = amb << 8 | pack4(__vcmpgtu4(x, 0x03030303u) & 0x01010101u);
      }
    } else {
      for (int i = 0; i < 16; ++i) {
        const uint32_t c = 16 * j + i < L ? (uint32_t)__ldg(p + i) : 0u;
        w = w << 2 | (c & 3u);
        amb = amb << 2 | (uint32_t)(c >= 4u);
      }
    }
    return w;
  }
}

// a 64-bit packed value's reverse complement: its 32 bases in reverse
// order, complemented
__device__ __forceinline__ uint64_t rc64(uint64_t x) {
  x = __brevll(x);
  return ~((x >> 1 & 0x5555555555555555ull) |
           (x & 0x5555555555555555ull) << 1);
}

// words of a slot serving `windows` consecutive windows of n bases: those
// the windows' bases span, and the two a cut reads past them
__host__ __device__ constexpr int tile_cap(int windows, int n) {
  return ((windows + n + 13) >> 4) + 3;
}

// A block's tile of rows in shared memory (dynamic, slots * stride words):
// slot s serves row b0 + s for windows from wa on (the kernel's range(s)),
// at most the `windows` of tile_cap.  A slot holds `cap` packed words of
// the row from word wa / 16 and, with the ambiguity mask, `cap` ambiguity
// words over the same bases.  `stride` is odd, so that the 32 slots read
// at one word index by a warp fall in 32 banks.  The reverse complement
// needs no words of its own: it is the reverse complement of forward cuts
// (rc64).
struct CutTile {
  uint32_t* sm;
  int cap, stride, n, W;   // W: the row's ceil(L / 16) words
  bool amb;

  // stage rows b0 .. b0 + slots - 1, slot s from window range(s); every
  // thread of the block calls it
  template <bool PACKED, typename RANGE>
  __device__ void stage(const void* codes, int row_stride, int L, int b0,
                        int slots, RANGE range) const {
    for (int e = threadIdx.x; e < slots * cap; e += blockDim.x) {
      const int s = e / cap, i = e - s * cap;
      const int j = (range(s) >> 4) + i;
      uint32_t f = 0u, a = 0u;
      if (j < W)
        f = row_word<PACKED>(static_cast<const char*>(codes) +
                                 (size_t)(b0 + s) * row_stride *
                                     (PACKED ? 4 : 1),
                             j, L, a);
      sm[s * stride + i] = f;
      if (!PACKED && amb) sm[s * stride + cap + i] = a;
    }
    __syncthreads();
  }

  // the key of window o of slot s (wa = range(s) <= o): hi the int64 key
  // for n <= 31; else the (hi, lo) pair, compared before lo's flip.  The
  // reverse complement of a key of n <= 31 bases is the low 2n bits of
  // rc64 of its forward cut; of a pair, hi is the top 31 bases of rc64 of
  // the cut of the window's last 32 bases, and lo the low 2 (n - 31) bits
  // of rc64 of the forward cut.
  template <bool TWO, bool CANON>
  __device__ __forceinline__ void key(int s, int o, int wa, int64_t& hi,
                                      int64_t& lo) const {
    const uint32_t* f = sm + s * stride;
    const int q = o - 16 * (wa >> 4);
    const uint64_t x = cut64(f, q);
    if constexpr (!TWO) {
      uint64_t v = x >> (64 - 2 * n);
      if constexpr (CANON) {
        const uint64_t c = rc64(x) & ((1ull << 2 * n) - 1);
        v = c < v ? c : v;
      }
      hi = (int64_t)v;
      lo = 0;
    } else {
      const int m = 2 * (n - HI_BASES);   // lo's bits: 2 .. 64
      uint64_t h = x >> 2, l = cut64(f, q + HI_BASES) >> (64 - m);
      if constexpr (CANON) {
        const uint64_t h2 = rc64(cut64(f, q + n - 32)) >> 2;
        const uint64_t l2 = rc64(x) & (~0ull >> (64 - m));
        if (h2 < h || (h2 == h && l2 < l)) {
          h = h2;
          l = l2;
        }
      }
      if (m == 64) l ^= 1ull << 63;
      hi = (int64_t)h;
      lo = (int64_t)l;
    }
  }

  // window o of slot s holds an ambiguous base (the ambiguity words are
  // staged)
  template <bool TWO>
  __device__ __forceinline__ bool ambiguous(int s, int o, int wa) const {
    const uint32_t* a = sm + s * stride + cap;
    const int q = o - 16 * (wa >> 4);
    if constexpr (!TWO) return (cut64(a, q) >> (64 - 2 * n)) != 0;
    return ((cut64(a, q) >> 2) |
            (cut64(a, q + HI_BASES) >> (64 - 2 * (n - HI_BASES)))) != 0;
  }
};

// Host: a cut tile's (cap, stride) for slots serving at most `windows`
// windows each, with the ambiguity words or without
inline void tile_shape(int windows, int n, bool amb, int& cap, int& stride) {
  cap = tile_cap(windows, n);
  stride = cap * (1 + (int)amb) | 1;
}

// Host: a launch's geometry and its kernel's attributes, for chip_smoke's
// report: info[0 .. 7) = threads a block, blocks, dynamic shared bytes,
// registers a thread, local (spill) bytes, resident blocks an SM, and the
// cudaError_t of the queries
constexpr int INFO_INTS = 7;

template <typename K>
void report(int* info, K kernel, unsigned blocks, int threads, size_t smem) {
  cudaFuncAttributes a = {};
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  const int v[INFO_INTS] = {threads, (int)blocks, (int)smem, a.numRegs,
                            (int)a.localSizeBytes, per_sm, (int)err};
  for (int i = 0; i < INFO_INTS; ++i) info[i] = v[i];
}

// Host: the runtime choices of a launch -> L::contiguous<KEY, PACKED,
// CANON>() for a contiguous key, L::gather<KEY, PACKED, CANON>() for a
// spaced seed of span over 64, L::rolled<KEY, SPAN, PACKED, CANON>() for a
// spaced seed of span <= 64.  KEY is uint64_t for keys of at most 31
// bases, else u128; SPAN is uint64_t when the span fits in 32 bases and the
// key in one word, else u128.
template <typename L, typename KEY, bool PACKED, bool CANON>
void run_spaced(const L& l, bool spaced, int span) {
  if (!spaced)
    l.template contiguous<KEY, PACKED, CANON>();
  else if (span > MAX_ROLLED_SPAN)
    l.template gather<KEY, PACKED, CANON>();
  else if constexpr (TWO_WORDS<KEY>)
    l.template rolled<KEY, u128, PACKED, CANON>();
  else if (span <= 32)
    l.template rolled<KEY, uint64_t, PACKED, CANON>();
  else
    l.template rolled<KEY, u128, PACKED, CANON>();
}

template <typename L, typename KEY, bool PACKED>
void run_canon(const L& l, bool canon, bool spaced, int span) {
  if (canon) run_spaced<L, KEY, PACKED, true>(l, spaced, span);
  else run_spaced<L, KEY, PACKED, false>(l, spaced, span);
}

template <typename L, typename KEY>
void run_packed(const L& l, bool packed, bool canon, bool spaced, int span) {
  if (packed) run_canon<L, KEY, true>(l, canon, spaced, span);
  else run_canon<L, KEY, false>(l, canon, spaced, span);
}

template <typename L>
void dispatch(const L& l, int n, bool packed, bool canon, bool spaced,
              int span) {
  if (n > HI_BASES) run_packed<L, u128>(l, packed, canon, spaced, span);
  else run_packed<L, uint64_t>(l, packed, canon, spaced, span);
}

// Host: the cut table's layout, for the wrappers to check their copy
// against: CUT_WORDS, CUT_TABLE_WORDS and MAX_ROLLED_SPAN
inline void cut_layout(int32_t* out) {
  out[0] = CUT_WORDS;
  out[1] = CUT_TABLE_WORDS;
  out[2] = MAX_ROLLED_SPAN;
}

}  // namespace kmer
