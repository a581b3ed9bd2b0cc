// Window extraction shared by csrc/fused_extract.cu (K1) and
// csrc/extract.cu (K7): the row reader, the rolling key of a contiguous
// window, the gathered key of a spaced seed, the key's int64 words, and the
// host dispatch from runtime choices to a kernel's template arguments.
//
// A key of n bases is its 2n-bit value, built in a uint64_t register for
// n <= 31 and in an unsigned __int128 for 32 <= n <= 63 (the KEY template
// argument), so numeric order on the register is the order of the keys and
// the canonical min is one compare.  It leaves the kernel in the layout of
// kmer_tpu_torch/ops/encode.py: one int64 for n <= 31; for 32 <= n <= 63
// the pair (hi, lo), hi the value of the first 31 bases and lo that of the
// last n - 31, with lo's top bit flipped when lo holds 32 bases (64 bits),
// so that signed int64 order on lo is the order of its bits.  A real hi is
// at most 62 bits and never equals SENTINEL.
//
// The build helper (kmer_tpu_torch/utils/build.py) rebuilds a kernel when
// this header is newer than its library.

#pragma once

#include <cstdint>

namespace kmer {

typedef unsigned __int128 u128;

constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;
constexpr int HI_BASES = 31;     // bases of one int64 key word
constexpr int MAX_BASES = 63;    // bases of a (hi, lo) pair

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

// A contiguous window of n bases rolled one base at a time: the forward
// value and the reverse complement, each O(1) a base.  The new base enters
// at the bottom, so the base leaving lo's top moves into hi when the
// 128-bit value is split.
template <typename KEY>
struct Roll {
  KEY fw = 0, rc = 0;
  KEY mask;
  int rc_shift;
  __device__ explicit Roll(int n)
      : mask(((KEY)1 << (2 * n)) - 1), rc_shift(2 * n - 2) {}
  template <bool CANON>
  __device__ __forceinline__ void push(uint32_t c) {
    fw = ((fw << 2) | c) & mask;
    if constexpr (CANON) rc = (rc >> 2) | ((KEY)(3u - c) << rc_shift);
  }
  template <bool CANON>
  __device__ __forceinline__ KEY key() const {
    if constexpr (CANON) return rc < fw ? rc : fw;
    return fw;
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

// Host: the runtime choices of a launch -> L::run<KEY, PACKED, CANON,
// SPACED>(), KEY uint64_t for keys of at most 31 bases, else u128.
template <typename L, typename KEY, bool PACKED, bool CANON>
void run_spaced(const L& l, bool spaced) {
  if (spaced) l.template run<KEY, PACKED, CANON, true>();
  else l.template run<KEY, PACKED, CANON, false>();
}

template <typename L, typename KEY, bool PACKED>
void run_canon(const L& l, bool canon, bool spaced) {
  if (canon) run_spaced<L, KEY, PACKED, true>(l, spaced);
  else run_spaced<L, KEY, PACKED, false>(l, spaced);
}

template <typename L, typename KEY>
void run_packed(const L& l, bool packed, bool canon, bool spaced) {
  if (packed) run_canon<L, KEY, true>(l, canon, spaced);
  else run_canon<L, KEY, false>(l, canon, spaced);
}

template <typename L>
void dispatch(const L& l, int n, bool packed, bool canon, bool spaced) {
  if (n > HI_BASES) run_packed<L, u128>(l, packed, canon, spaced);
  else run_packed<L, uint64_t>(l, packed, canon, spaced);
}

}  // namespace kmer
