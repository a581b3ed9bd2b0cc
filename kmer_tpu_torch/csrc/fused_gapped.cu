// Fused gapped count step for Hopper (sm_90a): the gapped L+R chunk keys
// of every chunk size, validity, sentinel and the in-segment all-pairs
// collapse in one pass.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/fused_gapped.py `_kernel`
// (entry fused_gapped_count_T) and the collapse it inlines,
// kmer_tpu/ops/pallas/fused_count.py `_dedup_runlen`.
//
// The lane stream of one read is c-major: for c = c_min .. min(c_max, L)
// the L - c + 1 offsets o, each lane the key (l-mer at o, r-mer at
// o + c - r_len) as an int64 pair (hi, lo).  Lane (c, o) is valid iff
// o + c <= len, o < limit and (mask_amb) neither window holds an
// ambiguous code; invalid and padding lanes are SENTINEL in both words.
// The output is read-major (B, T_pad), so the flat lane g = b T_pad + t
// runs over the whole batch, and since seg divides T_pad every segment is
// seg-aligned in g.
//
// What bounds it: bytes.  Each lane stores two 8-byte keys and a 1-byte
// count, 17 bytes; the input is ceil(L / 16) words a row, read from L1.
//
// Design.  The TPU kernel builds its sub-key tables with doubling or
// banded matmuls and combines them into repacked words with static shifts,
// because its vector lanes cannot gather.  The first port of it here gave
// each block one read and one tile of 4096 lanes, built the l-mer table of
// the whole row in shared memory before storing a lane, searched the
// chunk size of every segment and stored 8 bytes a lane a plane, a byte a
// count.  Its time was its stores: the same grid storing constant lanes
// the same way took as long.  What this design does about each cost:
// - the tables: there are none.  A window of n <= 31 bases is one cut of
//   the packed row, cut64(words, q) >> (64 - 2n), a few funnel shifts
//   (kmer_window.cuh): hi is the cut at o, lo the cut at o + c - r_len.
//   One cut holds the windows of the next 32 - max(l_len, r_len) offsets
//   too, so a step's later lanes shift it on instead of cutting anew.
//   Packed rows are read straight from device memory (the batch's rows
//   stay in L1).  u8 rows are staged: a warp packs rows_cap rows from its
//   piece's first (as many as a piece can touch) into shared memory with
//   row_word, two zero words past each row's end that a cut reads, and
//   with the mask the ambiguity words in the same layout, and keeps them
//   while they hold its later pieces; a window is ambiguous iff its cut
//   of the ambiguity words is not 0.  Where the rows would not fit
//   STAGE_WORDS, the cuts pack the row's words as they read them;
// - the tail wave and empty part-tiles: the grid is the card's resident
//   blocks (SMs x blocks an SM, no more than the lanes need), and each
//   warp takes an even share of the stream's steps, in order, a piece of
//   at most SPAN lanes at a time;
// - the search: a thread finds the (b, t) of its first lane in a piece by
//   one division and the chunk size c by a binary search over the closed
//   form lanes_before, then carries (b, c, o) lane by lane and step by
//   step; it searches again only where a step crosses a chunk's end;
// - the stores: a thread takes seg consecutive lanes a step, a warp 32 seg
//   consecutive lanes, so at seg 2 each key plane goes out in 16-byte
//   stores straight from registers, a warp instruction covering 512
//   contiguous bytes, and the counts in 2-byte stores, all with the
//   streaming (evict-first) hint: the output is written once and, at 81 MB
//   a parity batch, overflows the 50 MB L2 anyway; at seg 4 to 16 a
//   thread's 16-byte stores would lie a 16 seg-byte stride apart, so the
//   planes go through the warp's out slots in shared memory and leave as
//   16-byte stores of consecutive pairs.
// The collapse runs over each step's seg lanes in registers (SEG a
// template parameter).  Segments may straddle chunk-size boundaries, as
// on the TPU: equal (hi, lo) at different c are the same key, so the
// collapse stays sound.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_window.cuh"

namespace {

using kmer::SENTINEL;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LPT = 16;               // a thread's lanes in a piece, at most
constexpr int SPAN = 32 * LPT;        // a warp's lanes in a piece, at most
static_assert(LPT % 16 == 0, "every seg must divide a thread's lanes");
// most row words a warp stages; with its out slots a block then takes at
// most 8 x (4608 + 8192) bytes of shared memory, under Hopper's 227 KB
constexpr int STAGE_WORDS = 2048;
// widest seg whose key planes a thread stores straight from its registers
// (a warp's 16-byte stores then cover 32 x 16 contiguous bytes); wider
// segs go through the warp's out slots
constexpr int DIRECT_SEG = 2;

// bytes of a warp's out slots at seg: 32 slots of seg + 2 int64
__host__ __device__ constexpr int out_bytes(int seg) {
  return seg > DIRECT_SEG ? 32 * (seg + 2) * 8 : 0;
}

// lanes of the chunk sizes c_min .. c - 1 (each L - c' + 1 > 0)
__device__ __host__ inline int64_t lanes_before(int c, int c_min, int L) {
  const int64_t n = c - c_min;
  return n * (L + 1) - n * (c_min + c - 1) / 2;
}

// the chunk size of lane t < T: the largest c in [lo, hi] with
// lanes_before(c) <= t (lo's own lanes_before <= t)
__device__ inline int chunk_of(int64_t t, int lo, int hi, int c_min,
                               int L) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lanes_before(mid, c_min, L) <= t) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// words of a staged row: the row's ceil(L / 16) and the two past its end
// that a cut of its last window reads
__host__ __device__ inline int row_stride(int L) { return (L + 15) / 16 + 2; }

// The row words a warp's cuts read: staged in shared memory (rows b0 ..,
// RS words each, the ambiguity words RS * rows_cap after), or straight
// from the batch in device memory.
template <bool PACKED, bool STAGED>
struct Rows {
  uint32_t* sm;             // staged words of row b0
  int b0, RS, amb_off;
  const char* codes;        // the batch's rows, row_bytes apart
  int64_t row_bytes;
  int L, W;

  // the forward cut of row b at base q and, with amb, its ambiguity cut
  __device__ __forceinline__ uint64_t cut(int b, int q, bool amb,
                                          uint64_t& a) const {
    if constexpr (STAGED) {
      const uint32_t* w = sm + (b - b0) * RS;
      a = amb ? kmer::cut64(w + amb_off, q) : 0ull;
      return kmer::cut64(w, q);
    } else {
      const char* row = codes + b * row_bytes;
      const int j = q >> 4, s = 2 * (q & 15);
      uint32_t f[3], m[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f[i] = m[i] = 0u;
        if (j + i < W) f[i] = kmer::row_word<PACKED>(row, j + i, L, m[i]);
      }
      a = amb ? (uint64_t)__funnelshift_l(m[1], m[0], s) << 32 |
                    __funnelshift_l(m[2], m[1], s)
              : 0ull;
      return (uint64_t)__funnelshift_l(f[1], f[0], s) << 32 |
             __funnelshift_l(f[2], f[1], s);
    }
  }
};

// a warp's staging of rows b0 .. b0 + nrows - 1 (every lane calls it)
template <bool PACKED>
__device__ __forceinline__ void stage_rows(uint32_t* sm, const char* codes,
                                           int64_t row_bytes, int b0,
                                           int nrows, int L, int RS,
                                           int amb_off, bool amb) {
  const int W = (L + 15) >> 4;
  __syncwarp();                     // the piece before has read its rows
  for (int e = threadIdx.x & 31; e < nrows * RS; e += 32) {
    const int r = e / RS, j = e - r * RS;
    uint32_t f = 0u, a = 0u;
    if (j < W) f = kmer::row_word<PACKED>(codes + (b0 + r) * row_bytes, j, L,
                                          a);
    sm[e] = f;
    if (amb) sm[amb_off + e] = a;
  }
  __syncwarp();
}

// seg bytes of counts at once (seg-aligned); at seg 2 with the streaming
// hint, as the key planes
template <int SEG>
__device__ __forceinline__ void store_counts(int8_t* p,
                                             const int (&cnt)[SEG]) {
  uint32_t w[(SEG + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < SEG; ++j)
    w[j / 4] |= (uint32_t)(cnt[j] & 0xFF) << (8 * (j % 4));
  if constexpr (SEG == 2)
    __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)w[0]);
  if constexpr (SEG == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
  if constexpr (SEG == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  if constexpr (SEG == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

struct Args {
  const void* codes;
  int64_t row_bytes;
  const int32_t* lengths;
  const int32_t* limits;
  int64_t* hi;
  int64_t* lo;
  int8_t* counts;
  int64_t n;                // B * T_pad lanes
  int B, L, l_len, r_len, c_min, c_hi, T, T_pad, rows_cap, warp_bytes;
  bool amb;
};

// a step's key plane through the warp's out slots to device memory: each
// thread's seg lanes into its slot (SEG + 2 words, so that 8 threads'
// 16-byte writes fall in 32 banks), then the warp's 32 seg lanes from
// lane G on as 16-byte stores, consecutive threads at consecutive pairs
template <int SEG>
__device__ __forceinline__ void put_plane(int64_t* out, int64_t* plane,
                                          int64_t G, int64_t n,
                                          const int64_t (&k)[SEG]) {
  constexpr int P = SEG + 2;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < SEG / 2; ++m)
    reinterpret_cast<longlong2*>(out + lane * P)[m] =
        make_longlong2(k[2 * m], k[2 * m + 1]);
  __syncwarp();
#pragma unroll
  for (int m = 0; m < SEG / 2; ++m) {
    const int pair = 32 * m + lane;
    const int owner = pair / (SEG / 2), slot = pair % (SEG / 2);
    if (G + 2 * pair < n)
      reinterpret_cast<longlong2*>(plane + G)[pair] =
          reinterpret_cast<const longlong2*>(out + owner * P)[slot];
  }
  __syncwarp();
}

template <int SEG, bool PACKED, bool STAGED>
__global__ void __launch_bounds__(THREADS)
fused_gapped_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int STEP = 32 * SEG;      // lanes between a thread's steps
  constexpr int STEPS = LPT / SEG;
  constexpr bool SLOTS = SEG > DIRECT_SEG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int RS = row_stride(a.L);
  const bool amb = !PACKED && a.amb;
  uint32_t* mine = smem + warp * (a.warp_bytes / 4);
  int64_t* out = reinterpret_cast<int64_t*>(mine);
  Rows<PACKED, STAGED> rows;
  rows.sm = mine + out_bytes(SEG) / 4;
  rows.RS = RS;
  rows.amb_off = a.rows_cap * RS;
  rows.codes = static_cast<const char*>(a.codes);
  rows.row_bytes = a.row_bytes;
  rows.L = a.L;
  rows.W = (a.L + 15) >> 4;
  const int hs = 64 - 2 * a.l_len, rs = 64 - 2 * a.r_len;
  // the most bases a cut can move on and still hold both windows
  const int reuse = 32 - (a.l_len > a.r_len ? a.l_len : a.r_len);
  // this warp's steps: an even share of the stream's, in order
  const int64_t steps = (a.n + STEP - 1) / STEP;
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  const int64_t share = steps / warps, extra = steps % warps;
  const int64_t first = gw * share + (gw < extra ? gw : extra);
  const int64_t last = first + share + (gw < extra ? 1 : 0);

  // a piece of at most STEPS steps (SPAN lanes) at a time; the staged
  // rows are rows.b0 .. rows.b0 + staged - 1
  rows.b0 = 0;
  int staged = 0;
  for (int64_t s0 = first; s0 < last; s0 += STEPS) {
    const int64_t g0 = s0 * STEP;
    const int nsteps = (int)(last - s0 < STEPS ? last - s0 : STEPS);
    const int bp = (int)(g0 / a.T_pad);
    if constexpr (STAGED) {
      // stage rows_cap rows from the piece's first, unless the rows
      // staged for the piece before hold this piece's rows
      const int64_t g_end = g0 + (int64_t)nsteps * STEP;
      const int b_last = (int)(((g_end < a.n ? g_end : a.n) - 1) / a.T_pad);
      if (bp < rows.b0 || b_last >= rows.b0 + staged) {
        rows.b0 = bp;
        staged = a.B - bp < a.rows_cap ? a.B - bp : a.rows_cap;
        stage_rows<PACKED>(rows.sm, rows.codes, a.row_bytes, bp, staged,
                           a.L, RS, rows.amb_off, amb);
      }
    }
    // this thread's first lane: (b, t), then (c, o)
    int b = bp;
    int64_t t = g0 + lane * SEG - (int64_t)b * a.T_pad;
    if (t >= a.T_pad) {
      b += (int)(t / a.T_pad);
      t %= a.T_pad;
    }
    int c = a.c_hi + 1, o = 0;        // c > c_hi: a padding lane
    if (t < a.T) {
      c = chunk_of(t, a.c_min, a.c_hi, a.c_min, a.L);
      o = (int)(t - lanes_before(c, a.c_min, a.L));
    }
#pragma unroll 1
    for (int s = 0; s < nsteps; ++s) {
      const int64_t G = g0 + (int64_t)s * STEP;   // the warp's first lane
      const int64_t g = G + lane * SEG;
      int64_t kh[SEG], kl[SEG];
      if (g < a.n) {
        const int len = __ldg(a.lengths + b), lim = __ldg(a.limits + b);
        int cc = c, oo = o;
        // the step's cuts: made at a chunk's first lane or when the last
        // ones cannot reach this lane's windows, else moved on k bases
        uint64_t xh = 0, xl = 0, ah = 0, al = 0;
        int k = 0;
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          if (j > 0 && ++oo > a.L - cc) {   // the next chunk size
            ++cc;
            oo = 0;
          }
          const bool live = cc <= a.c_hi;
          if (j == 0 || oo == 0 || k == reuse) {
            const int qh = live ? oo : 0, ql = live ? oo + cc - a.r_len : 0;
            xh = rows.cut(b, qh, amb, ah);
            xl = rows.cut(b, ql, amb, al);
            k = 0;
          } else {
            ++k;
          }
          const int m = 2 * k;
          const bool ok = live && oo + cc <= len && oo < lim &&
                          (((ah << m) >> hs) | ((al << m) >> rs)) == 0;
          kh[j] = ok ? (int64_t)((xh << m) >> hs) : SENTINEL;
          kl[j] = ok ? (int64_t)((xl << m) >> rs) : SENTINEL;
        }
        // count on the first occurrence: itself + equal pairs later in
        // the segment; later duplicates and sentinels get 0
        int cnt[SEG];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          cnt[i] = 0;
          if (kh[i] != SENTINEL) {
            bool dup = false;
            int n = 1;
#pragma unroll
            for (int j = 0; j < SEG; ++j) {
              const bool eq = kh[j] == kh[i] && kl[j] == kl[i];
              if (j < i) dup |= eq;
              if (j > i) n += eq;
            }
            cnt[i] = dup ? 0 : n;
          }
        }
        store_counts<SEG>(a.counts + g, cnt);
        if constexpr (!SLOTS) {
#pragma unroll
          for (int j = 0; j < SEG; j += 2) {
            __stcs(reinterpret_cast<longlong2*>(a.hi + g) + j / 2,
                   make_longlong2(kh[j], kh[j + 1]));
            __stcs(reinterpret_cast<longlong2*>(a.lo + g) + j / 2,
                   make_longlong2(kl[j], kl[j + 1]));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < SEG; ++j) kh[j] = kl[j] = SENTINEL;
      }
      if constexpr (SLOTS) {
        put_plane<SEG>(out, a.hi, G, a.n, kh);
        put_plane<SEG>(out, a.lo, G, a.n, kl);
      }

      // the next step's first lane, STEP lanes on
      t += STEP;
      if (t >= a.T_pad) {               // another row: (c, o) anew
        b += (int)(t / a.T_pad);
        t %= a.T_pad;
        c = a.c_hi + 1;
        o = 0;
        if (t < a.T) {
          c = chunk_of(t, a.c_min, a.c_hi, a.c_min, a.L);
          o = (int)(t - lanes_before(c, a.c_min, a.L));
        }
      } else if (c <= a.c_hi && (o += STEP) > a.L - c) {
        // past chunk c: search the chunks after it, or the padding
        if (t < a.T) {
          c = chunk_of(t, c + 1, a.c_hi, a.c_min, a.L);
          o = (int)(t - lanes_before(c, a.c_min, a.L));
        } else {
          c = a.c_hi + 1;
        }
      }
    }
  }
}

// A launch's plan: the rows a warp's piece can touch, whether they are
// staged (u8 rows whose words, with the ambiguity words, fit STAGE_WORDS;
// packed rows never are), and the shared bytes of a warp (its out slots,
// then its staged rows) and of the block
struct Plan {
  int rows_cap;
  bool staged;
  int warp_bytes;
  size_t smem;
};

inline Plan plan_of(int B, int L, int64_t T_pad, bool packed, bool amb,
                    int seg) {
  // SPAN consecutive lanes touch at most ceil((SPAN - 1) / T_pad) + 1 rows
  const int64_t rows = (SPAN - 2 + T_pad) / T_pad + 1;
  Plan p;
  p.rows_cap = (int)(rows < B ? rows : B);
  const int64_t words = (int64_t)p.rows_cap * row_stride(L) * (amb ? 2 : 1);
  p.staged = !packed && words <= STAGE_WORDS;
  p.warp_bytes = out_bytes(seg) + (p.staged ? (int)(words + 3) / 4 * 16 : 0);
  p.smem = (size_t)WARPS * p.warp_bytes;
  return p;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// the blocks of a launch: the card's resident blocks, no more than the
// pieces need; its geometry into info when info is set (kmer::report)
template <int SEG, bool PACKED, bool STAGED>
int launch(const Args& a, const Plan& p, cudaStream_t st, int* info) {
  auto kern = fused_gapped_kernel<SEG, PACKED, STAGED>;
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, THREADS, p.smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t pieces = (a.n + SPAN - 1) / SPAN;
  const int64_t need = (pieces + WARPS - 1) / WARPS;
  const int64_t fill = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < fill ? need : fill);
  if (info != nullptr) {
    kmer::report(info, kern, blocks, THREADS, p.smem);
    return info[kmer::INFO_INTS - 1];
  }
  kern<<<blocks, THREADS, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int SEG>
int launch_seg(bool packed, const Args& a, const Plan& p, cudaStream_t st,
               int* info) {
  if (packed) return launch<SEG, true, false>(a, p, st, info);
  return p.staged ? launch<SEG, false, true>(a, p, st, info)
                  : launch<SEG, false, false>(a, p, st, info);
}

int launch_or_report(const void* codes, int packed, int row_stride_elems,
                     const int32_t* lengths, const int32_t* limits,
                     int64_t* hi, int64_t* lo, int8_t* counts, int B, int L,
                     int l_len, int r_len, int c_min, int c_max, int64_t T,
                     int64_t T_pad, int mask_amb, int seg, void* stream,
                     int* info) {
  const int c_hi = c_max < L ? c_max : L;
  if ((seg != 2 && seg != 4 && seg != 8 && seg != 16) || l_len < 1 ||
      l_len > kmer::HI_BASES || r_len < 1 || r_len > kmer::HI_BASES ||
      c_min < l_len + r_len || c_hi < c_min ||
      B < 1 || T < 1 || T != lanes_before(c_hi + 1, c_min, L) || T_pad < T ||
      T_pad % seg != 0 || T_pad > INT32_MAX - 2 * SPAN ||
      row_stride_elems < (packed ? (L + 15) / 16 : L))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(B, L, T_pad, packed != 0, !packed && mask_amb, seg);
  Args a;
  a.codes = codes;
  a.row_bytes = (int64_t)row_stride_elems * (packed ? 4 : 1);
  a.lengths = lengths;
  a.limits = limits;
  a.hi = hi;
  a.lo = lo;
  a.counts = counts;
  a.n = (int64_t)B * T_pad;
  a.B = B;
  a.L = L;
  a.l_len = l_len;
  a.r_len = r_len;
  a.c_min = c_min;
  a.c_hi = c_hi;
  a.T = (int)T;
  a.T_pad = (int)T_pad;
  a.rows_cap = p.rows_cap;
  a.warp_bytes = p.warp_bytes;
  a.amb = mask_amb != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (seg) {
    case 2: return launch_seg<2>(packed != 0, a, p, st, info);
    case 4: return launch_seg<4>(packed != 0, a, p, st, info);
    case 8: return launch_seg<8>(packed != 0, a, p, st, info);
    case 16: return launch_seg<16>(packed != 0, a, p, st, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// codes: (B, row_stride) int32 words of 16 packed bases (packed != 0) or
// (B, row_stride) uint8 codes; lengths/limits: (B,) int32; hi, lo:
// (B, T_pad) int64; counts: (B, T_pad) int8.  T is the lane count of a
// row (T > 0).  Returns the launch's cudaError_t.
extern "C" int fused_gapped_count_launch(
    const void* codes, int packed, int row_stride, const int32_t* lengths,
    const int32_t* limits, int64_t* hi, int64_t* lo, int8_t* counts, int B,
    int L, int l_len, int r_len, int c_min, int c_max, int64_t T,
    int64_t T_pad, int mask_amb, int seg, void* stream) {
  return launch_or_report(codes, packed, row_stride, lengths, limits, hi, lo,
                          counts, B, L, l_len, r_len, c_min, c_max, T, T_pad,
                          mask_amb, seg, stream, nullptr);
}

// the launch fused_gapped_count_launch would make, without making it:
// info[0 .. 7) as kmer::report gives it; returns its cudaError_t
extern "C" int fused_gapped_info(int packed, int B, int L, int l_len,
                                 int r_len, int c_min, int c_max, int64_t T,
                                 int64_t T_pad, int mask_amb, int seg,
                                 int* info) {
  return launch_or_report(nullptr, packed, packed ? (L + 15) / 16 : L,
                          nullptr, nullptr, nullptr, nullptr, nullptr, B, L,
                          l_len, r_len, c_min, c_max, T, T_pad, mask_amb, seg,
                          nullptr, info);
}

