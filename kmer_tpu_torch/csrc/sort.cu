// Stable multi-word sort of W int64 word planes (1 <= W <= MAX_PLANES) for
// Hopper (sm_90a), in place: the rows (w0[i], ..., w{W-1}[i]) ordered by their
// first K words (the keys), compared as signed int64 with word 0 most
// significant; the other W - K words ride along as payload, and rows with
// equal keys keep their input order.  The all-INT64_MAX sentinel row
// sorts last.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/sort.py `sort_words_pallas`
// (`_chunk_sort_kernel`, `_chunk_merge_kernel` and the cross-chunk stage
// `_cross_chunk_stage` between them), which sorts every word as a key.
//
// What bounds it: memory.  The least work is one read and one write of
// every plane.  A least-significant-digit radix sort moves every plane
// once a digit of every key word (27 times at the k = 101 device merge);
// this is a hybrid most-significant-digit (MSD) radix sort after Stehle &
// Jacobsen (SIGMOD 2017), which moves every plane about three times:
// one or two device-wide scatters by a leading digit, then each bucket
// sorted whole in shared memory and written once.
//
// Key codes.  Key word q carries a promise bits[q] that its values lie in
// [0, 2^bits) or are the sentinel; its code is
//   bits < 64:  v == INT64_MAX ? 2^bits : v   (bits + 1 significant bits:
//               the sentinel sorts last without widening the range)
//   bits == 64: v ^ 2^63                      (signed order as unsigned)
// and rows sort by their codes, word 0 first.
//
// Levels.  A bucket is a range of rows whose codes agree above some bit.
// Level 0 is the whole input, split by the top 8 significant bits of key
// word 0 (a static digit: the sentinel rows, code 2^bits, take a digit of
// their own).  At every later level a bucket first ANDs and ORs its codes
// (reduce_kernel: OR ^ AND marks the bits that vary inside it), from the
// first key word that may still vary; its digit is the 8-bit window below
// the highest varying bit, so constant bits are skipped, and a bucket in
// which nothing varies is done where it stands (every scatter was
// stable): the sentinel padding of a device-merge state, a k-mer repeated
// millions of times.  A level's split is three kernels over the buckets'
// runs, one tile each: hist_kernel counts a run's digits, scan_kernel
// scans the counts of every run over the level (one block a digit), and
// scatter_kernel ranks its run's rows stably (a warp walks its rows in
// row order, eight ballots group the lanes of one digit), stages every
// plane in shared memory in digit order and writes it out, each digit's
// rows from the bucket's start, the digits before it and the runs before
// this one (the scanned counts).  The first run's block of
// a bucket also files its children: a child of more than LOCAL rows whose
// codes may still vary becomes a bucket of the next level; the others are
// packed, in order, into local tiles of at most LOCAL rows.
//
// Local sort (local_kernel).  A block takes a tile of at most LOCAL rows
// (one or several whole buckets): it loads the codes of the first key
// word that varies over the tile into shared memory (AND and OR find the
// varying bits) and sorts a 16-bit row index by LSD passes over only the
// 8-bit windows that cover them; runs of rows whose codes tie are then put
// in order by the later key words as a small sub-list (fix_runs), or,
// where that list would pass half a tile, the whole tile is sorted again
// word by word from the last.  Then it writes every plane once, reading
// the tile's rows (contiguous, in L2) through the index.
//
// The levels ping-pong between the caller's planes (A) and a second set in
// the scratch (B): level j reads A when j is even.  A local tile reads
// whichever buffer its rows are in and writes A; a tile whose rows are
// done and lie in B is copied.  A plan of one level (one key word of at
// most 8 significant bits: the mesh's owner partition) copies the planes
// to B first, so that its one scatter writes A and nothing is left to
// copy.  The work lists (buckets, their runs, the local tiles) live in
// the scratch and are filed by atomics on the device, so the host never
// reads a bucket size.  A bucket's split consumes at
// least its window, so no row is split more than LEVELS = sum over the
// key words of ceil(significant bits / 8) times; the launches are four a
// level (reduce, hist, scan, scatter; level 0 has no reduce, and its
// hist's first block zeroes the counters) and one local: 4 LEVELS, from K
// and the bits alone (3 for one level).  A level without work costs its
// empty launches.  Row indices are 64-bit throughout.
//
// The planes travel by value, as a struct of up to MAX_PLANES pointers
// whose size is chosen by W (4, 16 or 240 planes; a launch's parameter
// copy grows with it); the scatter and local kernels are unrolled for
// W <= 4 and loop over the planes beyond.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;              // reduce, hist and scatter blocks
constexpr int ITEMS = 16;                 // rows a thread of a tile
constexpr int TILE = THREADS * ITEMS;     // 4096 rows
// rows a run, a hist or scatter block's work item: one tile (runs of four
// tiles, their digits' next rows carried from tile to tile, were slower
// on small inputs, as fewer blocks shared the work, and no faster at 25 M
// rows)
constexpr int RUN_ROWS = TILE;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;                 // 8-bit digits
constexpr int LANE_BINS = BINS / 32;      // a lane's bins in a warp's scan
constexpr int SCAN_THREADS = 1024;
constexpr int LOCAL_THREADS = 512;
constexpr int LOCAL_ITEMS = 16;
constexpr int LOCAL = LOCAL_THREADS * LOCAL_ITEMS;   // 8192 rows a tile
constexpr int LOCAL_WARPS = LOCAL_THREADS / 32;
constexpr int MAX_ENTRIES = 2 * BINS + 1;  // a split's filings
constexpr int FIX_MAX = LOCAL / 2;         // rows a local run fix-up sorts
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_PLANES = 240;

static_assert(THREADS == BINS, "a scatter thread a digit");

// A call's levels, its work lists' capacities and its scratch (int64
// words).
struct Plan {
  int levels;
  int64_t cap_b;      // buckets a level: more than LOCAL rows each
  int64_t cap_r;      // runs a level
  int64_t cap_t;      // local tiles
  int64_t rec;        // words a bucket record
  int64_t n_ctr;      // counters: buckets and runs a level, local tiles
  int64_t words;      // the whole scratch
};

inline int sig_bits(int bits) { return bits < 64 ? bits + 1 : 64; }

Plan plan_of(int W, int K, const int* bits, int64_t n) {
  Plan p;
  p.levels = 0;
  for (int q = 0; q < K; ++q) p.levels += (sig_bits(bits[q]) + 7) / 8;
  p.cap_b = n / (LOCAL + 1) + 1;
  p.cap_r = n / RUN_ROWS + p.cap_b + 1;
  p.cap_t = 2 * (n / LOCAL + 1) + 4 * (int64_t)p.levels * p.cap_b;
  p.rec = 5 + 2 * (int64_t)K;
  p.n_ctr = 2 * ((int64_t)p.levels + 1) + 1;
  p.words = W * n + BINS * (p.cap_r + 1) + 2 * p.cap_r +
            2 * p.cap_b * p.rec + 2 * p.cap_t + p.n_ctr;
  return p;
}

// Everything a launch needs, by value.  Level j reads buffer
// (j + flip) & 1 (0 the caller's planes, 1 the second set).  Bucket record
// (rec words, in two sets, level j's in set j & 1): start, size, first
// run, runs, the first key word that may vary (q0), then AND and OR of
// each key word's codes.
// A run item: its bucket's index.  A local tile: its first row, then
// size | q_start << 32 | source buffer << 48 | copy << 49.  Counters:
// buckets of level j at 2 j, its runs at 2 j + 1, local tiles last.
template <int P>
struct Args {
  int64_t* a[P];            // the caller's planes
  unsigned char bits[P];    // the key words' value bits
  int64_t* b;               // the second set: plane q at b + q * n
  int64_t n;
  int W, K, levels;
  int flip;                 // 1: the rows start in B (one-level plans)
  int64_t rec, cap_b, cap_r, cap_t;
  int64_t* counts;          // BINS x (cap_r + 1): digit-major run counts
  int64_t* items;           // 2 x cap_r
  int64_t* buckets;         // 2 x cap_b x rec
  int64_t* tiles;           // cap_t x 2
  unsigned long long* ctr;  // n_ctr
};

template <int P>
__device__ __forceinline__ int64_t* plane(const Args<P>& g, int buf, int q) {
  return buf ? g.b + (int64_t)q * g.n : g.a[q];
}

// the buffer level j reads
template <int P>
__device__ __forceinline__ int level_buf(const Args<P>& g, int level) {
  return (level + g.flip) & 1;
}

__device__ __forceinline__ uint64_t code_of(int64_t v, int bits) {
  return bits < 64 ? (v == INT64_MAX ? 1ull << bits : (uint64_t)v)
                   : (uint64_t)v ^ (1ull << 63);
}

// A bucket's split: digit (code of key word q >> lo) & (2^nb - 1); nb == 0
// when nothing varies in it.
struct Split {
  int q, lo, nb;
  __device__ __forceinline__ unsigned of(int64_t v, int bits) const {
    return (unsigned)(code_of(v, bits) >> lo) & ((1u << nb) - 1u);
  }
};

template <int P>
__device__ Split decide(const Args<P>& g, int level, const int64_t* rec) {
  Split s = {0, 0, 0};
  if (level == 0) {
    const int sig = g.bits[0] < 64 ? g.bits[0] + 1 : 64;
    s.lo = sig > 8 ? sig - 8 : 0;
    s.nb = sig - s.lo;
    return s;
  }
  const int K = g.K;
  for (int q = (int)rec[4]; q < K; ++q) {
    const uint64_t m = (uint64_t)rec[5 + K + q] ^ (uint64_t)rec[5 + q];
    if (m) {
      const int hv = 63 - __clzll((long long)m);
      s.q = q;
      s.lo = hv > 7 ? hv - 7 : 0;
      s.nb = hv - s.lo + 1;
      return s;
    }
  }
  return s;
}

__device__ __forceinline__ int64_t tile_info(int64_t size, int q_start,
                                             int src, int copy) {
  return size | (int64_t)q_start << 32 | (int64_t)src << 48 |
         (int64_t)copy << 49;
}

// the lanes holding the same 8-bit digit as this one: eight ballots, one a
// bit (with __match_any_sync instead the whole sort took 8-22% longer on
// an H100 at the merge shapes of scripts/ab_sort.py)
__device__ __forceinline__ unsigned peers_of(unsigned d) {
  unsigned m = FULL;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned v = __ballot_sync(FULL, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

// inclusive scan over a warp's lanes
template <typename T>
__device__ __forceinline__ T warp_scan(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// the AND and OR of a block's values, in every thread (s: 2 * warps words)
template <int NWARPS>
__device__ __forceinline__ void block_and_or(unsigned long long& a,
                                             unsigned long long& o,
                                             unsigned long long* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a &= __shfl_xor_sync(FULL, a, off);
    o |= __shfl_xor_sync(FULL, o, off);
  }
  if (lane == 0) {
    s[warp] = a;
    s[NWARPS + warp] = o;
  }
  __syncthreads();
  a = ~0ull;
  o = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    a &= s[w];
    o |= s[NWARPS + w];
  }
  __syncthreads();
}

// a work list's length: its counter, no more than its capacity
__device__ __forceinline__ int64_t listed(const unsigned long long* c,
                                          int64_t cap) {
  return (int64_t)*c < cap ? (int64_t)*c : cap;
}

// A level's bucket: its rows [start, start + size), its runs [first,
// first + runs) of the level's run list, and its record (none at level 0,
// whose one bucket is every row).
struct Bucket {
  int64_t start, size, first, runs;
  int64_t* rec;
  // the rows of run r, [row0, end)
  __device__ __forceinline__ void rows(int64_t r, int64_t& row0,
                                       int64_t& end) const {
    row0 = start + (r - first) * RUN_ROWS;
    end = start + size < row0 + RUN_ROWS ? start + size : row0 + RUN_ROWS;
  }
};

// level 0's runs: every row's, or none where the rows go to the local
// sort whole (n <= LOCAL, more than one level)
template <int P>
__device__ __forceinline__ int64_t level0_runs(const Args<P>& g) {
  return g.n > LOCAL || g.flip ? (g.n + RUN_ROWS - 1) / RUN_ROWS : 0;
}

template <int P>
__device__ __forceinline__ int64_t runs_of(const Args<P>& g, int level) {
  return level == 0 ? level0_runs(g)
                    : listed(&g.ctr[2 * level + 1], g.cap_r);
}

template <int P>
__device__ __forceinline__ Bucket bucket_of(const Args<P>& g, int level,
                                            int64_t r) {
  if (level == 0) return {0, g.n, 0, level0_runs(g), nullptr};
  const int set = level & 1;
  int64_t* rec =
      g.buckets + (set * g.cap_b + g.items[set * g.cap_r + r]) * g.rec;
  return {rec[0], rec[1], rec[2], rec[3], rec};
}

// levels >= 1: each run's AND and OR of its bucket's codes into the
// bucket, key word by key word from q0, stopping after the first word that
// varies inside the run (a word that varies inside a run varies inside the
// bucket, so the words after it cannot choose the digit)
template <int P>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const __grid_constant__ Args<P> g, int level) {
  __shared__ unsigned long long s_ao[2 * WARPS];
  const int64_t nr = runs_of(g, level);
  for (int64_t r = blockIdx.x; r < nr; r += gridDim.x) {
    const Bucket bk = bucket_of(g, level, r);
    int64_t* rec = bk.rec;
    int64_t row0, end;
    bk.rows(r, row0, end);
    for (int q = (int)rec[4]; q < g.K; ++q) {
      const int64_t* key = plane(g, level_buf(g, level), q);
      const int bits = g.bits[q];
      unsigned long long a = ~0ull, o = 0;
#pragma unroll 8
      for (int64_t i = row0 + threadIdx.x; i < end; i += THREADS) {
        const uint64_t c = code_of(key[i], bits);
        a &= c;
        o |= c;
      }
      block_and_or<WARPS>(a, o, s_ao);
      if (threadIdx.x == 0) {
        atomicAnd(reinterpret_cast<unsigned long long*>(rec + 5 + q), a);
        atomicOr(reinterpret_cast<unsigned long long*>(rec + 5 + g.K + q),
                 o);
      }
      if (a ^ o) break;
    }
  }
}

// each run's digit counts, counts[d * (cap_r + 1) + r]; zeros for a done
// bucket's runs
template <int P>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const __grid_constant__ Args<P> g, int level) {
  __shared__ unsigned s_hist[WARPS * BINS];        // a histogram a warp
  const int64_t nr = runs_of(g, level);
  const int64_t stride = g.cap_r + 1;
  const int warp = threadIdx.x >> 5;
  if (level == 0 && blockIdx.x == 0) {
    // the call's start: the counters zeroed; rows that go to the local
    // sort whole, its one tile
    const bool whole = nr == 0;
    const int64_t n_ctr = 2 * ((int64_t)g.levels + 1) + 1;
    for (int64_t i = threadIdx.x; i < n_ctr; i += THREADS)
      g.ctr[i] = i == n_ctr - 1 ? (unsigned long long)whole : 0ull;
    if (whole && threadIdx.x == 0) {
      g.tiles[0] = 0;
      g.tiles[1] = tile_info(g.n, 0, 0, 0);
    }
  }
  for (int64_t r = blockIdx.x; r < nr; r += gridDim.x) {
    const Bucket bk = bucket_of(g, level, r);
    const Split s = decide(g, level, bk.rec);
    for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) s_hist[i] = 0;
    __syncthreads();
    if (s.nb) {
      int64_t row0, end;
      bk.rows(r, row0, end);
      const int64_t* key = plane(g, level_buf(g, level), s.q);
      const int bits = g.bits[s.q];
      unsigned* wh = s_hist + warp * BINS;
#pragma unroll 8
      for (int64_t i = row0 + threadIdx.x; i < end; i += THREADS)
        atomicAdd(&wh[s.of(key[i], bits)], 1u);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < BINS; d += THREADS) {
      unsigned sum = 0;
      for (int w = 0; w < WARPS; ++w) sum += s_hist[w * BINS + d];
      g.counts[(int64_t)d * stride + r] = sum;
    }
    __syncthreads();
  }
}

// one block a digit: its row of run counts scanned over the level's runs
// (exclusive, in place), the total after the last run
template <int P>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const __grid_constant__ Args<P> g, int level) {
  __shared__ int64_t s_warp[SCAN_THREADS / 32];
  const int64_t tiles = runs_of(g, level);
  int64_t* row = g.counts + (int64_t)blockIdx.x * (g.cap_r + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t carry = 0;
  for (int64_t start = 0; start < tiles; start += SCAN_THREADS) {
    const int64_t t = start + threadIdx.x;
    const int64_t x = t < tiles ? row[t] : 0;
    const int64_t s = warp_scan(x, lane);
    if (lane == 31) s_warp[warp] = s;
    __syncthreads();
    if (warp == 0) s_warp[lane] = warp_scan(s_warp[lane], lane);
    __syncthreads();
    if (t < tiles) row[t] = carry + (warp ? s_warp[warp - 1] : 0) + s - x;
    carry += s_warp[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0 && tiles > 0) row[tiles] = carry;
}

// `count` slots of counter c, or -1 past cap (a sort that would overflow
// drops rows, which every check against the plain version sees)
__device__ __forceinline__ int64_t reserve(unsigned long long* c,
                                           int64_t count, int64_t cap) {
  if (count == 0) return 0;
  const int64_t base = (int64_t)atomicAdd(c, (unsigned long long)count);
  return base + count <= cap ? base : -1;
}

// a done bucket's rows, which lie in B, filed as copy tiles (block-wide)
template <int P>
__device__ void file_copy(const Args<P>& g, int64_t start, int64_t size,
                          int64_t* s_base) {
  const int64_t chunks = (size + LOCAL - 1) / LOCAL;
  if (threadIdx.x == 0)
    *s_base = reserve(&g.ctr[2 * (g.levels + 1)], chunks, g.cap_t);
  __syncthreads();
  const int64_t base = *s_base;
  if (base >= 0)
    for (int64_t c = threadIdx.x; c < chunks; c += THREADS) {
      const int64_t left = size - c * LOCAL;
      g.tiles[2 * (base + c)] = start + c * LOCAL;
      g.tiles[2 * (base + c) + 1] =
          tile_info(left < LOCAL ? left : LOCAL, 0, 1, 1);
    }
  __syncthreads();
}

// A split bucket's children (sizes s_tot[d], first rows s_first[d]),
// filed by its first run's block (block-wide).  Children land in buffer
// dbuf.  Thread 0 walks the digits in order: a child of more than LOCAL
// rows whose codes may still vary is a bucket of the next level; one in
// which nothing can vary is done (copied if it lies in B); the others are
// packed into local tiles of at most LOCAL rows, flushed before a child
// that does not fit and around the large ones.  A tile of children that
// are sorted already (nothing left to vary, or one row each) is a copy
// when it lies in B and nothing otherwise.  Then one reservation a list,
// and the threads write the entries.
template <int P>
__device__ void file_children(const Args<P>& g, int level, Split s,
                              const int64_t* s_tot, const int64_t* s_first,
                              int64_t* ent, int64_t* s_emit) {
  const int K = g.K;
  const int q0c = s.lo > 0 ? s.q : s.q + 1;
  const int dbuf = level_buf(g, level + 1);
  if (threadIdx.x == 0) {
    const bool left = q0c < K;
    int64_t ne = 0, nt = 0, nb = 0, nr = 0;
    int64_t gstart = 0, gsize = 0;
    bool gsort = false;
    // entry: start, size, kind (0 sort tile, 1 copy, 2 bucket), slot
    // offsets (tiles or buckets; runs)
    auto add = [&](int kind, int64_t st, int64_t sz) {
      int64_t* e = ent + 5 * ne++;
      e[0] = st;
      e[1] = sz;
      e[2] = kind;
      if (kind == 2) {
        e[3] = nb++;
        e[4] = nr;
        nr += (sz + RUN_ROWS - 1) / RUN_ROWS;
      } else {
        e[3] = nt;
        nt += kind == 1 ? (sz + LOCAL - 1) / LOCAL : 1;
      }
    };
    auto flush = [&]() {
      if (gsize > 0 && (gsort || dbuf == 1)) add(gsort ? 0 : 1, gstart,
                                                 gsize);
      gsize = 0;
      gsort = false;
    };
    for (int d = 0; d < (1 << s.nb); ++d) {
      const int64_t t = s_tot[d];
      if (t == 0) continue;
      if (t <= LOCAL) {
        if (gsize + t > LOCAL) flush();
        if (gsize == 0) gstart = s_first[d];
        gsize += t;
        gsort |= left && t > 1;
      } else {
        flush();
        if (left) add(2, s_first[d], t);
        else if (dbuf == 1) add(1, s_first[d], t);
      }
    }
    flush();
    s_emit[0] = ne;
    s_emit[1] = reserve(&g.ctr[2 * (g.levels + 1)], nt, g.cap_t);
    s_emit[2] = reserve(&g.ctr[2 * (level + 1)], nb, g.cap_b);
    s_emit[3] = reserve(&g.ctr[2 * (level + 1) + 1], nr, g.cap_r);
  }
  __syncthreads();
  const int64_t ne = s_emit[0], base_t = s_emit[1], base_b = s_emit[2],
                base_r = s_emit[3];
  const int nset = (level + 1) & 1;
  for (int64_t i = threadIdx.x; i < ne; i += THREADS) {
    const int64_t* e = ent + 5 * i;
    const int64_t st = e[0], sz = e[1];
    if (e[2] == 0) {
      if (base_t < 0) continue;
      g.tiles[2 * (base_t + e[3])] = st;
      g.tiles[2 * (base_t + e[3]) + 1] = tile_info(sz, s.q, dbuf, 0);
    } else if (e[2] == 1) {
      if (base_t < 0) continue;
      for (int64_t c = 0; c * LOCAL < sz; ++c) {
        const int64_t left = sz - c * LOCAL;
        g.tiles[2 * (base_t + e[3] + c)] = st + c * LOCAL;
        g.tiles[2 * (base_t + e[3] + c) + 1] =
            tile_info(left < LOCAL ? left : LOCAL, 0, dbuf, 1);
      }
    } else {
      if (base_b < 0 || base_r < 0) continue;
      const int64_t id = base_b + e[3], first = base_r + e[4];
      const int64_t runs = (sz + RUN_ROWS - 1) / RUN_ROWS;
      int64_t* rec = g.buckets + (nset * g.cap_b + id) * g.rec;
      rec[0] = st;
      rec[1] = sz;
      rec[2] = first;
      rec[3] = runs;
      rec[4] = q0c;
      for (int q = q0c; q < K; ++q) {
        rec[5 + q] = -1;
        rec[5 + K + q] = 0;
      }
      int64_t* items = g.items + nset * g.cap_r + first;
      for (int64_t j = 0; j < runs; ++j) items[j] = id;
    }
  }
  __syncthreads();
}

// shared memory of scatter_kernel
constexpr size_t SCATTER_SMEM =
    TILE * sizeof(int64_t)                 // s_buf: one word of the tile
    + BINS * sizeof(int64_t)               // s_off: a digit's rows less slots
    + BINS * sizeof(int64_t)               // s_run: a digit's first row
    + WARPS * BINS * sizeof(unsigned)      // s_whist: per-warp digit counts
    + BINS * sizeof(unsigned)              // s_lbase: a digit's tile start
    + TILE;                                // s_digit: the digit at a slot
static_assert((2 * BINS + 5 * MAX_ENTRIES) * sizeof(int64_t) <=
                  TILE * sizeof(int64_t),
              "the filing lists fit s_buf");

// one word of the tile, staged in s_buf in digit order, to its rows: slot
// p of digit d goes to row s_off[d] + p
__device__ __forceinline__ void write_out(const int64_t* s_buf,
                                          const int64_t* s_off,
                                          const unsigned char* s_digit,
                                          int tile_n, int64_t* out) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = j * THREADS + threadIdx.x;
    if (p < tile_n) out[s_off[s_digit[p]] + p] = s_buf[p];
  }
}

// each run's rows scattered stably by its bucket's digit, from the
// level's buffer to the other, every plane; W > 0: W planes, their loops
// unrolled; W == 0: g.W planes
template <int P, int W>
__global__ void __launch_bounds__(THREADS, 3)
scatter_kernel(const __grid_constant__ Args<P> g, int level) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_buf = reinterpret_cast<int64_t*>(smem);
  int64_t* s_off = s_buf + TILE;
  int64_t* s_run = s_off + BINS;
  unsigned* s_whist = reinterpret_cast<unsigned*>(s_run + BINS);
  unsigned* s_lbase = s_whist + WARPS * BINS;
  unsigned char* s_digit = reinterpret_cast<unsigned char*>(s_lbase + BINS);
  __shared__ int64_t s_w[WARPS];
  __shared__ int64_t s_emit[4];

  const int src = level_buf(g, level), dst = src ^ 1;
  const int64_t nr = runs_of(g, level);
  const int64_t stride = g.cap_r + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = warp * (ITEMS * 32) + lane;     // item 0's row in a tile
  const int NW = W > 0 ? W : g.W;

  for (int64_t r = blockIdx.x; r < nr; r += gridDim.x) {
    const Bucket bk = bucket_of(g, level, r);
    const int64_t start = bk.start, size = bk.size, fr = bk.first;
    const Split s = decide(g, level, bk.rec);
    if (s.nb == 0) {                       // done: copied if it lies in B
      if (r == fr && src == 1) file_copy(g, start, size, s_emit);
      continue;
    }
    {
      // thread d: the digit's first row in the bucket (the bucket's start
      // and the digits before it) and in this run (the runs before it)
      const int d = threadIdx.x;
      const int64_t* e = g.counts + (int64_t)d * stride;
      const int64_t e0 = e[fr], tot = e[fr + bk.runs] - e0, er = e[r] - e0;
      const int64_t inc = warp_scan(tot, lane);
      if (lane == 31) s_w[warp] = inc;
      __syncthreads();
      int64_t before = 0;
      for (int w = 0; w < warp; ++w) before += s_w[w];
      const int64_t first = start + before + inc - tot;
      s_run[d] = first + er;
      if (r == fr) {
        s_buf[d] = tot;
        s_buf[BINS + d] = first;
      }
      __syncthreads();
    }
    if (r == fr)
      file_children(g, level, s, s_buf, s_buf + BINS, s_buf + 2 * BINS,
                    s_emit);

    const int64_t* key = plane(g, src, s.q);
    const int bits = g.bits[s.q];
    int64_t tile0, tile_end;
    bk.rows(r, tile0, tile_end);
    const int tile_n = (int)(tile_end - tile0);
    for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS)
      s_whist[i] = 0;
    int64_t v[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int rr = row0 + i * 32;
      v[i] = rr < tile_n ? key[tile0 + rr] : 0;
    }
    __syncthreads();

    // rank within the warp, in row order: digit << 16 | rank
    unsigned* wh = s_whist + warp * BINS;
    const unsigned below_mask = (1u << lane) - 1u;
    unsigned dr[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned d =
          row0 + i * 32 < tile_n ? s.of(v[i], bits) : BINS - 1;
      const unsigned peers = peers_of(d);
      const unsigned below = __popc(peers & below_mask);
      const unsigned c = wh[d];
      __syncwarp();
      if (below == 0) wh[d] = c + __popc(peers);
      __syncwarp();
      dr[i] = d << 16 | (c + below);
    }
    __syncthreads();

    // each digit: the warps' counts scanned in warp order; the tile's
    // count
    for (int d = threadIdx.x; d < BINS; d += THREADS) {
      unsigned sum = 0;
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = s_whist[w * BINS + d];
        s_whist[w * BINS + d] = sum;
        sum += c;
      }
      s_lbase[d] = sum;
    }
    __syncthreads();
    // warp 0: the digits' starts in the tile
    if (warp == 0) {
      unsigned c[LANE_BINS], sum = 0;
#pragma unroll
      for (int j = 0; j < LANE_BINS; ++j) {
        c[j] = s_lbase[lane * LANE_BINS + j];
        sum += c[j];
      }
      unsigned ex = warp_scan(sum, lane) - sum;
#pragma unroll
      for (int j = 0; j < LANE_BINS; ++j) {
        s_lbase[lane * LANE_BINS + j] = ex;
        ex += c[j];
      }
    }
    __syncthreads();

    // each row's slot in digit order; the key word staged there
    int pos[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned d = dr[i] >> 16;
      pos[i] = s_lbase[d] + s_whist[warp * BINS + d] + (dr[i] & 0xFFFFu);
      s_digit[pos[i]] = (unsigned char)d;
      s_buf[pos[i]] = v[i];
    }
    for (int d = threadIdx.x; d < BINS; d += THREADS)
      s_off[d] = s_run[d] - s_lbase[d];
    __syncthreads();
    // the key word from s_buf; then each other word loaded, staged and
    // written the same way
#pragma unroll
    for (int q = 0; q < NW; ++q)
      if (q == s.q)
        write_out(s_buf, s_off, s_digit, tile_n, plane(g, dst, q));
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      if (q == s.q) continue;
      const int64_t* in = plane(g, src, q);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int rr = row0 + i * 32;
        v[i] = rr < tile_n ? in[tile0 + rr] : 0;
      }
      __syncthreads();                  // s_buf's last word is out
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) s_buf[pos[i]] = v[i];
      __syncthreads();
      write_out(s_buf, s_off, s_digit, tile_n, plane(g, dst, q));
    }
    __syncthreads();                      // the next run reuses it all
  }
}

// shared memory of local_kernel
constexpr size_t LOCAL_SMEM =
    LOCAL * sizeof(uint64_t)                      // s_key: codes, a plane,
                                                  // or fix_runs' lists
    + 2 * LOCAL * sizeof(unsigned short)          // s_perm: two row indices
    + LOCAL_WARPS * BINS * sizeof(unsigned short) // s_whist
    + BINS * sizeof(unsigned);                    // s_lbase

// one stable LSD pass of a local tile: the rows in order `in`, by digit
// (s_key[row] >> lo) & 255, into order `out`
__device__ __forceinline__ void local_pass(const uint64_t* s_key,
                                           const unsigned short* in,
                                           unsigned short* out, int m, int lo,
                                           unsigned short* s_whist,
                                           unsigned* s_lbase) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < LOCAL_WARPS * BINS; i += LOCAL_THREADS)
    s_whist[i] = 0;
  __syncthreads();
  const int p0 = warp * (LOCAL_ITEMS * 32) + lane;
  unsigned short* wh = s_whist + warp * BINS;
  const unsigned below_mask = (1u << lane) - 1u;
  unsigned dr[LOCAL_ITEMS];
#pragma unroll
  for (int i = 0; i < LOCAL_ITEMS; ++i) {
    const int p = p0 + i * 32;
    const unsigned d =
        p < m ? (unsigned)(s_key[in[p]] >> lo) & (BINS - 1) : BINS - 1;
    const unsigned peers = peers_of(d);
    const unsigned below = __popc(peers & below_mask);
    const unsigned c = wh[d];
    __syncwarp();
    if (below == 0) wh[d] = (unsigned short)(c + __popc(peers));
    __syncwarp();
    dr[i] = d << 16 | (c + below);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < BINS; d += LOCAL_THREADS) {
    unsigned sum = 0;
    for (int w = 0; w < LOCAL_WARPS; ++w) {
      const unsigned c = s_whist[w * BINS + d];
      s_whist[w * BINS + d] = (unsigned short)sum;
      sum += c;
    }
    s_lbase[d] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned c[LANE_BINS], sum = 0;
#pragma unroll
    for (int j = 0; j < LANE_BINS; ++j) {
      c[j] = s_lbase[lane * LANE_BINS + j];
      sum += c[j];
    }
    unsigned ex = warp_scan(sum, lane) - sum;
#pragma unroll
    for (int j = 0; j < LANE_BINS; ++j) {
      s_lbase[lane * LANE_BINS + j] = ex;
      ex += c[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < LOCAL_ITEMS; ++i) {
    const int p = p0 + i * 32;
    if (p < m) {
      const unsigned d = dr[i] >> 16;
      out[s_lbase[d] + s_whist[warp * BINS + d] + (dr[i] & 0xFFFFu)] = in[p];
    }
  }
  __syncthreads();
}

// a local tile's rows [0, m) of `in`, each handed to put(row, value): a
// thread's rows loaded eight at a time before any is used, so that the
// loads are in flight together
template <typename F>
__device__ __forceinline__ void tile_rows(const int64_t* __restrict__ in,
                                          int m, F put) {
  constexpr int B = 8;
#pragma unroll
  for (int i0 = 0; i0 < LOCAL_ITEMS; i0 += B) {
    int64_t v[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int p = (i0 + i) * LOCAL_THREADS + threadIdx.x;
      v[i] = p < m ? in[p] : 0;
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int p = (i0 + i) * LOCAL_THREADS + threadIdx.x;
      if (p < m) put(p, v[i]);
    }
  }
}

// LSD passes over the 8-bit windows covering `mask`, lowest first: the
// order moves between perm and perm + stride, `cur` naming the one it is
// in; returns the passes made
__device__ __forceinline__ int lsd_windows(unsigned long long mask,
                                           const uint64_t* key,
                                           unsigned short* perm, int stride,
                                           int& cur, int m,
                                           unsigned short* s_whist,
                                           unsigned* s_lbase) {
  int passes = 0;
  while (mask) {
    const int lo = __ffsll((long long)mask) - 1;
    mask = lo + 8 < 64 ? mask & (~0ull << (lo + 8)) : 0ull;
    local_pass(key, perm + cur * stride, perm + (cur ^ 1) * stride, m, lo,
               s_whist, s_lbase);
    cur ^= 1;
    ++passes;
  }
  return passes;
}

// key word q's codes of a local tile into s_key; returns the bits that
// vary over the tile (syncs: s_key is in)
template <int P>
__device__ unsigned long long load_codes(const Args<P>& g, int src,
                                         int64_t start, int m, int q,
                                         uint64_t* s_key,
                                         unsigned long long* s_ao) {
  const int bits = g.bits[q];
  unsigned long long a = ~0ull, o = 0;
  tile_rows(plane(g, src, q) + start, m, [&](int p, int64_t v) {
    const uint64_t c = code_of(v, bits);
    s_key[p] = c;
    a &= c;
    o |= c;
  });
  block_and_or<LOCAL_WARPS>(a, o, s_ao);
  return a ^ o;
}

// an exclusive scan of one int a thread of a local block, and its total
__device__ __forceinline__ int local_scan(int x, int* s_w, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_scan(x, lane);
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < LOCAL_WARPS; ++w) {
    const int t = s_w[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + inc - x;
}

// The tile's rows are in order `perm` by key word qf (codes by row in
// s_key); each run of rows with equal codes is put in order by the later
// key words.  Runs whose later words agree throughout (duplicate keys)
// stay as they are.  The rows of the others, in position order, form a
// sub-list sorted by LSD passes over the later words' varying windows and
// then over their run's index (stable: rows that tie keep their order),
// and go back into the runs' positions.  The sub-list works in s_key's
// space (run indices, positions, codes) and in `spare`, the other order
// buffer, halved.  Returns false, having changed nothing, when it would
// pass FIX_MAX rows.
template <int P>
__device__ bool fix_runs(const Args<P>& g, int src, int64_t start, int m,
                         int qf, uint64_t* s_key, unsigned short* perm,
                         unsigned short* spare, unsigned short* s_whist,
                         unsigned* s_lbase, unsigned* s_need,
                         unsigned long long* s_ao, int* s_w) {
  constexpr int R = LOCAL_ITEMS;          // contiguous positions a thread
  const int p0 = threadIdx.x * R;
  // run heads, and rows whose later words differ from the row before
  unsigned head = 0, diff = 0;
  for (int i = 0; i < R && p0 + i < m; ++i) {
    const int p = p0 + i, row = perm[p];
    if (p == 0 || s_key[row] != s_key[perm[p - 1]]) {
      head |= 1u << i;
      continue;
    }
    const int prev = perm[p - 1];
    for (int q = qf + 1; q < g.K; ++q) {
      const int64_t* w = plane(g, src, q) + start;
      if (w[row] != w[prev]) {
        diff |= 1u << i;
        break;
      }
    }
  }
  if (!__syncthreads_or(diff != 0)) return true;
  for (int i = threadIdx.x; i < LOCAL / 32; i += LOCAL_THREADS) s_need[i] = 0;
  // each position's run; the runs that hold a difference
  int total;
  int rid = local_scan(__popc(head), s_w, total) - 1;
  unsigned short* s_rid = reinterpret_cast<unsigned short*>(s_key);
  for (int i = 0; i < R && p0 + i < m; ++i) {
    rid += (head >> i) & 1;
    s_rid[p0 + i] = (unsigned short)rid;
    if ((diff >> i) & 1) atomicOr(&s_need[rid >> 5], 1u << (rid & 31));
  }
  __syncthreads();
  unsigned member = 0;
  for (int i = 0; i < R && p0 + i < m; ++i) {
    const int r = s_rid[p0 + i];
    member |= ((s_need[r >> 5] >> (r & 31)) & 1u) << i;
  }
  int ms;
  int idx = local_scan(__popc(member), s_w, ms);
  if (ms > FIX_MAX) return false;
  unsigned short* s_pos = s_rid + LOCAL;          // the sub-list's positions
  uint64_t* s_sub = s_key + LOCAL / 2;            // its codes
  for (int i = 0; i < R; ++i)
    if ((member >> i) & 1) s_pos[idx++] = (unsigned short)(p0 + i);
  for (int i = threadIdx.x; i < ms; i += LOCAL_THREADS) spare[i] = i;
  __syncthreads();
  int cur = 0;
  for (int q = g.K - 1; q >= qf; --q) {
    // the later words, last first; then (q == qf) the run indices
    const int64_t* w = plane(g, src, q) + start;
    const int bits = g.bits[q];
    unsigned long long a = ~0ull, o = 0;
    for (int i = threadIdx.x; i < ms; i += LOCAL_THREADS) {
      const int p = s_pos[i];
      const uint64_t c = q > qf ? code_of(w[perm[p]], bits) : s_rid[p];
      s_sub[i] = c;
      a &= c;
      o |= c;
    }
    block_and_or<LOCAL_WARPS>(a, o, s_ao);
    lsd_windows(a ^ o, s_sub, spare, FIX_MAX, cur, ms, s_whist, s_lbase);
  }
  // the sub-list's rows in order, back into its positions
  unsigned short* s_rows = reinterpret_cast<unsigned short*>(s_sub);
  const unsigned short* order = spare + cur * FIX_MAX;
  for (int j = threadIdx.x; j < ms; j += LOCAL_THREADS)
    s_rows[j] = perm[s_pos[order[j]]];
  __syncthreads();
  for (int j = threadIdx.x; j < ms; j += LOCAL_THREADS)
    perm[s_pos[j]] = s_rows[j];
  __syncthreads();
  return true;
}

// The distinct codes among a local tile's m codes in s_key, estimated by
// linear counting: each code hashed to one of LOCAL bits (in s_bits),
// distinct ~ -LOCAL ln(1 - set / LOCAL).  It picks a path, never a result.
__device__ float distinct_codes(const uint64_t* s_key, int m,
                                unsigned* s_bits, int* s_w) {
  for (int i = threadIdx.x; i < LOCAL / 32; i += LOCAL_THREADS) s_bits[i] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < m; p += LOCAL_THREADS) {
    const unsigned h =
        (unsigned)((s_key[p] * 0x9E3779B97F4A7C15ull) >> 51);   // 13 bits
    atomicOr(&s_bits[h >> 5], 1u << (h & 31));
  }
  __syncthreads();
  int set = 0;
  for (int i = threadIdx.x; i < LOCAL / 32; i += LOCAL_THREADS)
    set += __popc(s_bits[i]);
  int total;
  local_scan(set, s_w, total);
  return total >= LOCAL ? (float)LOCAL
                        : -(float)LOCAL * logf(1.f - (float)total / LOCAL);
}

// Each local tile sorted in shared memory and written to A once.  The
// tile is sorted by its first key word that varies (qf) by LSD passes
// over that word's varying windows, and its runs of equal qf codes are
// then put in order by the later words (fix_runs): rows seldom share a
// whole key word, so the later words cost little.  Where the rows that tie
// on qf pass FIX_MAX (gapped keys, whose first word repeats once a gap
// length; keys that share their first word by the thousand), the tile is
// sorted by LSD passes over every key word from the last to qf instead:
// up front when the tile's distinct qf codes, estimated, say so, or after
// the qf passes when fix_runs finds its sub-list too long.  Either path
// gives the same order.
template <int P, int W>
__global__ void __launch_bounds__(LOCAL_THREADS, 2)
local_kernel(const __grid_constant__ Args<P> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_key + LOCAL);
  unsigned short* s_whist = s_perm + 2 * LOCAL;
  unsigned* s_lbase = reinterpret_cast<unsigned*>(s_whist + LOCAL_WARPS * BINS);
  __shared__ unsigned long long s_ao[2 * LOCAL_WARPS];
  __shared__ unsigned s_need[LOCAL / 32];
  __shared__ int s_w[LOCAL_WARPS];
  const int64_t nt = listed(&g.ctr[2 * (g.levels + 1)], g.cap_t);
  const int NW = W > 0 ? W : g.W;
  for (int64_t t = blockIdx.x; t < nt; t += gridDim.x) {
    const int64_t start = g.tiles[2 * t];
    const int64_t info = g.tiles[2 * t + 1];
    const int m = (int)(info & 0xFFFFFFFF);
    const int q_start = (int)((info >> 32) & 0xFFFF);
    const int src = (int)((info >> 48) & 1);
    const bool copy = (info >> 49) & 1;
    int cur = 0, passes = 0;
    if (!copy) {
      for (int p = threadIdx.x; p < m; p += LOCAL_THREADS) s_perm[p] = p;
      int qf = q_start;
      unsigned long long mask =
          load_codes(g, src, start, m, qf, s_key, s_ao);
      while (!mask && qf + 1 < g.K)
        mask = load_codes(g, src, start, m, ++qf, s_key, s_ao);
      // word by word, from the last to qf, from the rows' own order
      auto wordwise = [&]() {
        for (int p = threadIdx.x; p < m; p += LOCAL_THREADS) s_perm[p] = p;
        cur = 0;
        for (int q = g.K - 1; q >= qf; --q) {
          __syncthreads();               // s_key is the next word's
          passes += lsd_windows(load_codes(g, src, start, m, q, s_key, s_ao),
                                s_key, s_perm, LOCAL, cur, m, s_whist,
                                s_lbase);
        }
      };
      if (qf + 1 < g.K && mask &&
          m - distinct_codes(s_key, m, s_need, s_w) > FIX_MAX) {
        wordwise();
      } else {
        passes = lsd_windows(mask, s_key, s_perm, LOCAL, cur, m, s_whist,
                             s_lbase);
        if (passes && qf + 1 < g.K &&
            !fix_runs(g, src, start, m, qf, s_key, s_perm + cur * LOCAL,
                      s_perm + (cur ^ 1) * LOCAL, s_whist, s_lbase, s_need,
                      s_ao, s_w))
          wordwise();
      }
      __syncthreads();                   // s_key is the planes' now
    }
    if (passes == 0 && src == 0) continue;       // the rows are in place
    const unsigned short* perm = s_perm + cur * LOCAL;
    int64_t* s_row = reinterpret_cast<int64_t*>(s_key);
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int64_t* in = plane(g, src, q) + start;
      int64_t* out = g.a[q] + start;
      if (passes == 0) {
        tile_rows(in, m, [&](int p, int64_t v) { out[p] = v; });
        continue;
      }
      tile_rows(in, m, [&](int p, int64_t v) { s_row[p] = v; });
      __syncthreads();
      for (int p = threadIdx.x; p < m; p += LOCAL_THREADS)
        out[p] = s_row[perm[p]];
      __syncthreads();
    }
  }
}

template <int P, int W>
int set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel<P, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SCATTER_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(local_kernel<P, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)LOCAL_SMEM);
  return (int)err;
}

// kernel launches a call makes: hist, scan and scatter at level 0; reduce,
// hist, scan and scatter a later level; the local sort, but for a plan of
// one level, whose scatter leaves nothing to sort or copy
inline int64_t launches_of(const Plan& p) {
  return 4 * (int64_t)p.levels - (p.levels == 1);
}

// the grids: a block per run or local tile at most, four an SM for the
// reduce and hist kernels, three (its resident blocks) for the scatter
// kernel, two for the local kernel
struct Grids {
  int64_t run, scatter, local;
};

Grids grids(const Plan& p, int sms) {
  auto most = [](int64_t cap, int64_t g) { return cap < g ? cap : g; };
  return {most(p.cap_r, 4 * (int64_t)sms), most(p.cap_r, 3 * (int64_t)sms),
          most(p.cap_t, 2 * (int64_t)sms)};
}

template <int P, int W>
int sort_rows(int64_t* const* planes, int nw, int K, const int* bits,
              int64_t n, int64_t* scratch, cudaStream_t st) {
  int err = set_smem<P, W>();
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const Plan p = plan_of(nw, K, bits, n);
  Args<P> g = {};
  for (int q = 0; q < nw; ++q) g.a[q] = planes[q];
  for (int q = 0; q < K; ++q) g.bits[q] = (unsigned char)bits[q];
  g.b = scratch;
  g.n = n;
  g.W = nw;
  g.K = K;
  g.levels = p.levels;
  g.flip = p.levels == 1;
  g.rec = p.rec;
  g.cap_b = p.cap_b;
  g.cap_r = p.cap_r;
  g.cap_t = p.cap_t;
  g.counts = scratch + nw * n;
  g.items = g.counts + BINS * (p.cap_r + 1);
  g.buckets = g.items + 2 * p.cap_r;
  g.tiles = g.buckets + 2 * p.cap_b * p.rec;
  g.ctr = reinterpret_cast<unsigned long long*>(g.tiles + 2 * p.cap_t);
  const Grids gr = grids(p, sms);
  // one level (one key word of at most 8 significant bits, the mesh's
  // owner partition): its children are done, so the rows are first
  // copied to B and the level scatters them back into A
  for (int q = 0; q < nw && g.flip; ++q)
    if ((err = (int)cudaMemcpyAsync(g.b + q * n, planes[q],
                                    n * sizeof(int64_t),
                                    cudaMemcpyDeviceToDevice, st)))
      return err;
  for (int level = 0; level < p.levels; ++level) {
    if (level > 0)
      reduce_kernel<P><<<(unsigned)gr.run, THREADS, 0, st>>>(g, level);
    hist_kernel<P><<<(unsigned)gr.run, THREADS, 0, st>>>(g, level);
    scan_kernel<P><<<BINS, SCAN_THREADS, 0, st>>>(g, level);
    scatter_kernel<P, W><<<(unsigned)gr.scatter, THREADS, SCATTER_SMEM, st>>>(
        g, level);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (g.flip) return 0;                  // nothing is left to sort or copy
  local_kernel<P, W><<<(unsigned)gr.local, LOCAL_THREADS, LOCAL_SMEM, st>>>(
      g);
  return (int)cudaGetLastError();
}

// the kernels' registers, spills and resident blocks for `info`
template <int P, int W>
int report(int64_t* info) {
  int err = set_smem<P, W>();
  if (err) return err;
  cudaFuncAttributes fs, fl;
  int bs = 0, bl = 0;
  if ((err = (int)cudaFuncGetAttributes(&fs, scatter_kernel<P, W>)) ||
      (err = (int)cudaFuncGetAttributes(&fl, local_kernel<P, W>)) ||
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &bs, scatter_kernel<P, W>, THREADS, SCATTER_SMEM)) ||
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &bl, local_kernel<P, W>, LOCAL_THREADS, LOCAL_SMEM)))
    return err;
  info[0] = fs.numRegs;
  info[1] = fs.localSizeBytes;
  info[2] = bs;
  info[3] = fl.numRegs;
  info[4] = fl.localSizeBytes;
  info[5] = bl;
  info[6] = P;
  return 0;
}

bool bad_shape(int W, int K, const int* bits, int64_t n) {
  if (W < 1 || W > MAX_PLANES || K < 1 || K > W || n < 1 ||
      n > ((int64_t)1 << 40) || bits == nullptr)
    return true;
  for (int q = 0; q < K; ++q)
    if (bits[q] < 0 || bits[q] > 64) return true;
  return false;
}

}  // namespace

// int64 words of the scratch block sort_words_launch needs for W planes of
// n rows sorted by K key words of these bits: W * n for the second set of
// planes, then the run counts, the work lists and the counters; -1 for a
// shape it does not take.
extern "C" int64_t sort_scratch_words(int W, int K, const int* bits,
                                      int64_t n) {
  if (bad_shape(W, K, bits, n)) return -1;
  return plan_of(W, K, bits, n).words;
}

// The plan of a call, host arithmetic only: out[0 .. 10) = levels,
// launches, tile rows, run rows, local rows, bucket, run and local-tile
// capacities, words a bucket record, scratch words.
extern "C" int sort_plan(int W, int K, const int* bits, int64_t n,
                         int64_t* out) {
  if (bad_shape(W, K, bits, n) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(W, K, bits, n);
  const int64_t v[10] = {p.levels, launches_of(p), TILE,
                         RUN_ROWS, LOCAL, p.cap_b, p.cap_r, p.cap_t, p.rec,
                         p.words};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The launches of a call on the current device, without making them:
// out[0 .. 15) = the grids of the reduce and hist kernels, of the scatter
// kernel and of the local kernel, the threads of the run and local
// kernels, the scatter and local kernels' dynamic shared bytes, the scan
// kernel's threads, then registers, spill bytes and resident blocks an SM
// of the scatter kernel and of the local kernel, and the planes of the
// parameter struct.
extern "C" int sort_launch_info(int W, int K, const int* bits, int64_t n,
                                int64_t* out) {
  if (bad_shape(W, K, bits, n) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const Grids gr = grids(plan_of(W, K, bits, n), sms);
  out[0] = gr.run;
  out[1] = gr.scatter;
  out[2] = gr.local;
  out[3] = THREADS;
  out[4] = LOCAL_THREADS;
  out[5] = SCATTER_SMEM;
  out[6] = LOCAL_SMEM;
  out[7] = SCAN_THREADS;
  switch (W) {
    case 1: return report<4, 1>(out + 8);
    case 2: return report<4, 2>(out + 8);
    case 3: return report<4, 3>(out + 8);
    case 4: return report<4, 4>(out + 8);
    default:
      return W <= 16 ? report<16, 0>(out + 8) : report<MAX_PLANES, 0>(out + 8);
  }
}

extern "C" int sort_tile_rows() { return TILE; }

extern "C" int sort_local_rows() { return LOCAL; }

extern "C" int sort_run_rows() { return RUN_ROWS; }

extern "C" int sort_max_planes() { return MAX_PLANES; }

// planes: W host pointers to n int64 rows each, sorted in place on
// `stream` by their first K words; bits: the K key words' value bits
// (0..64).  scratch: sort_scratch_words(W, K, bits, n) int64 words on the
// device.  1 <= K <= W <= MAX_PLANES, 1 <= n <= 2^40.  Returns the first
// failing call's cudaError_t, or 0; never synchronises.
extern "C" int sort_words_launch(int64_t* const* planes, int W, int K,
                                 const int* bits, int64_t n,
                                 int64_t* scratch, void* stream) {
  if (bad_shape(W, K, bits, n) || scratch == nullptr || planes == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < W; ++q)
    if (planes[q] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return sort_rows<4, 1>(planes, W, K, bits, n, scratch, st);
    case 2: return sort_rows<4, 2>(planes, W, K, bits, n, scratch, st);
    case 3: return sort_rows<4, 3>(planes, W, K, bits, n, scratch, st);
    case 4: return sort_rows<4, 4>(planes, W, K, bits, n, scratch, st);
    default:
      return W <= 16
                 ? sort_rows<16, 0>(planes, W, K, bits, n, scratch, st)
                 : sort_rows<MAX_PLANES, 0>(planes, W, K, bits, n, scratch,
                                            st);
  }
}
