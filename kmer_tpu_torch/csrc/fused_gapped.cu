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
//
// What bounds it: memory.  Each lane costs two 8-byte key stores and a
// 1-byte count store (T_pad x B x 17 bytes a batch); the input is one
// row of L bases per read, read once per block.
//
// Design: the TPU kernel builds its sub-key tables with doubling or
// banded matmuls and combines them into repacked words with static
// shifts, because its vector lanes cannot gather.  Here a block takes
// one read and one TILE of its lane stream: it unpacks the row into
// shared memory, builds the l-mer table (and the r-mer table when
// r_len != l_len) as int64 values there, -1 marking a window with an
// ambiguous base, and then every thread forms its lanes with two
// shared-memory reads.  Each thread takes SEG consecutive lanes a step,
// so a warp stores 32 x SEG consecutive lanes of one row: the output is
// read-major (B, T_pad), one contiguous run per block.  The collapse
// runs over the SEG pairs held in registers (SEG a template parameter,
// as in fused_extract.cu).  Segments may straddle chunk-size
// boundaries, as on the TPU: equal (hi, lo) at different c are the same
// key, so the collapse stays sound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;     // lanes per block; every SEG divides it
constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;
constexpr int MAX_SMEM = 232448;   // a Hopper block's dynamic shared memory

// lanes of the chunk sizes c_min .. c-1 (each L - c' + 1 > 0)
__device__ __host__ inline int64_t lanes_before(int c, int c_min, int L) {
  const int64_t n = c - c_min;
  return n * (L + 1) - n * (c_min + c - 1) / 2;
}

// the n-mer value at every start p < P; -1 where the window holds an
// ambiguous code and mask_amb is set (values have at most 62 bits)
__device__ inline void build_table(int64_t* tab, const uint8_t* cs, int P,
                                   int n, int mask_amb) {
  for (int p = threadIdx.x; p < P; p += THREADS) {
    uint64_t v = 0;
    bool amb = false;
    for (int j = 0; j < n; ++j) {
      const uint32_t c = cs[p + j];
      amb |= c >= 4u;
      v = (v << 2) | (c & 3u);
    }
    tab[p] = (mask_amb && amb) ? -1 : (int64_t)v;
  }
}

template <int SEG, bool PACKED>
__global__ void __launch_bounds__(THREADS)
fused_gapped_kernel(const void* __restrict__ codes, int row_stride,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ limits,
                    int64_t* __restrict__ hi_out, int64_t* __restrict__ lo_out,
                    int8_t* __restrict__ counts, int L, int l_len, int r_len,
                    int c_min, int c_hi, int64_t T, int64_t T_pad,
                    int mask_amb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int P_l = L - l_len + 1, P_r = L - r_len + 1;
  int64_t* ltab = reinterpret_cast<int64_t*>(smem);
  int64_t* rtab = r_len == l_len ? ltab : ltab + P_l;
  uint8_t* cs = reinterpret_cast<uint8_t*>(
      ltab + P_l + (r_len == l_len ? 0 : P_r));

  // 1. the row's codes into shared memory
  if constexpr (PACKED) {
    const uint32_t* prow =
        static_cast<const uint32_t*>(codes) + (size_t)b * row_stride;
    for (int w = threadIdx.x; w < row_stride; w += THREADS) {
      const uint32_t word = __ldg(prow + w);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int q = w * 16 + j;
        if (q < L) cs[q] = (word >> (30 - 2 * j)) & 3u;
      }
    }
  } else {
    const uint8_t* urow =
        static_cast<const uint8_t*>(codes) + (size_t)b * row_stride;
    for (int q = threadIdx.x; q < L; q += THREADS) cs[q] = __ldg(urow + q);
  }
  __syncthreads();

  // 2. the sub-key tables
  build_table(ltab, cs, P_l, l_len, mask_amb);
  if (r_len != l_len) build_table(rtab, cs, P_r, r_len, mask_amb);
  __syncthreads();

  // 3. the lanes of this block's tile, SEG at a time
  const int len = lengths[b], lim = limits[b];
  int64_t* hrow = hi_out + (size_t)b * T_pad;
  int64_t* lrow = lo_out + (size_t)b * T_pad;
  int8_t* crow = counts + (size_t)b * T_pad;
  const int64_t tile0 = (int64_t)blockIdx.y * TILE;
  for (int s = threadIdx.x; s < TILE / SEG; s += THREADS) {
    const int64_t t0 = tile0 + (int64_t)s * SEG;
    if (t0 >= T_pad) break;
    // chunk size of lane t0: the largest c with lanes_before(c) <= t0
    const int64_t target = t0 < T ? t0 : T - 1;
    int lo_c = c_min, hi_c = c_hi;
    while (lo_c < hi_c) {
      const int mid = (lo_c + hi_c + 1) / 2;
      if (lanes_before(mid, c_min, L) <= target) lo_c = mid;
      else hi_c = mid - 1;
    }
    int c = lo_c;
    int64_t base = lanes_before(c, c_min, L);
    int64_t next = base + (L - c + 1);

    int64_t kh[SEG], kl[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      const int64_t t = t0 + j;
      if (t >= next && c < c_hi) {      // every chunk size has >= 1 lane
        ++c;
        base = next;
        next = base + (L - c + 1);
      }
      int64_t h = SENTINEL, w = SENTINEL;
      if (t < T) {
        const int o = (int)(t - base);
        if (o + c <= len && o < lim) {
          h = ltab[o];
          w = rtab[o + c - r_len];
          if (h < 0 || w < 0) h = w = SENTINEL;
        }
      }
      kh[j] = h;
      kl[j] = w;
      hrow[t] = h;
      lrow[t] = w;
    }
    // count on the first occurrence: itself + equal pairs later in the
    // segment; later duplicates and sentinels get 0
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      int cnt = 0;
      if (kh[i] != SENTINEL) {
        bool dup = false;
        cnt = 1;
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          const bool eq = kh[j] == kh[i] && kl[j] == kl[i];
          if (j < i) dup |= eq;
          if (j > i) cnt += eq;
        }
        if (dup) cnt = 0;
      }
      crow[t0 + i] = (int8_t)cnt;
    }
  }
}

// bytes of dynamic shared memory a block needs for rows of width L: the
// tables (8 bytes a start) and the row's codes (1 byte a base)
inline int64_t smem_bytes(int L, int l_len, int r_len) {
  const int64_t tabs = (int64_t)(L - l_len + 1) +
                       (r_len == l_len ? 0 : (int64_t)(L - r_len + 1));
  return 8 * tabs + ((L + 15) / 16) * 16;
}

template <int SEG, bool PACKED>
int launch(dim3 grid, size_t smem, cudaStream_t st, const void* codes,
           int row_stride, const int32_t* lengths, const int32_t* limits,
           int64_t* hi, int64_t* lo, int8_t* counts, int L, int l_len,
           int r_len, int c_min, int c_hi, int64_t T, int64_t T_pad,
           int mask_amb) {
  auto kern = fused_gapped_kernel<SEG, PACKED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, THREADS, smem, st>>>(codes, row_stride, lengths, limits, hi,
                                    lo, counts, L, l_len, r_len, c_min, c_hi,
                                    T, T_pad, mask_amb);
  return (int)cudaGetLastError();
}

template <int SEG>
int launch_seg(bool packed, dim3 grid, size_t smem, cudaStream_t st,
               const void* codes, int row_stride, const int32_t* lengths,
               const int32_t* limits, int64_t* hi, int64_t* lo,
               int8_t* counts, int L, int l_len, int r_len, int c_min,
               int c_hi, int64_t T, int64_t T_pad, int mask_amb) {
  return packed
      ? launch<SEG, true>(grid, smem, st, codes, row_stride, lengths, limits,
                          hi, lo, counts, L, l_len, r_len, c_min, c_hi, T,
                          T_pad, mask_amb)
      : launch<SEG, false>(grid, smem, st, codes, row_stride, lengths,
                           limits, hi, lo, counts, L, l_len, r_len, c_min,
                           c_hi, T, T_pad, mask_amb);
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
  const int c_hi = c_max < L ? c_max : L;
  const int64_t smem = smem_bytes(L, l_len, r_len);
  const int64_t tiles = (T_pad + TILE - 1) / TILE;
  if (l_len < 1 || l_len > 31 || r_len < 1 || r_len > 31 ||
      c_min < l_len + r_len || c_hi < c_min || B < 1 || T < 1 ||
      T != lanes_before(c_hi + 1, c_min, L) || T_pad < T ||
      T_pad % seg != 0 || smem > MAX_SMEM || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (unsigned)tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KMER_SEG(S)                                                          \
  case S:                                                                    \
    return launch_seg<S>(packed != 0, grid, (size_t)smem, st, codes,         \
                         row_stride, lengths, limits, hi, lo, counts, L,     \
                         l_len, r_len, c_min, c_hi, T, T_pad, mask_amb);
  switch (seg) {
    KMER_SEG(2)
    KMER_SEG(4)
    KMER_SEG(8)
    KMER_SEG(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef KMER_SEG
}
