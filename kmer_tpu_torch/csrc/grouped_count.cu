// Grouped run lengths and grouped sort + run lengths for Hopper (sm_90a),
// over W in {1, 2, 3, 4} int64 word planes (a row is (w0[e], ..., w{W-1}[e]),
// compared lexicographically as signed int64, word 0 most significant; a
// row whose word 0 is SENTINEL = INT64_MAX is a dead lane).
//
// Three entry points, each replacing a TPU kernel of
// kmer_tpu/ops/pallas/fused_count.py:
//   run_lengths_grouped_launch (K2a) <- `_scan_kernel`
//       (run_lengths_grouped_pallas): counts of group-sorted rows;
//   grouped_sort_count_launch with strides (1, m) (K2b) <- `_kernel`
//       (fused_grouped_count): sort each contiguous group, then counts;
//   grouped_sort_count_launch with strides (G, 1) (K2c) <- `_kernel` with
//       axis 0 (fused_grouped_count_sublane): the same over groups that are
//       strided columns, element i of group g at i * G + g.
// The count contract of all three: a run of equal rows inside a group has
// its length at its first row, every other row 0, and a dead run 0.
//
// What bounds them: memory for K2a (one read of each row, and of its left
// neighbour, which the cache serves; one int32 write); for K2b/K2c the
// sorting network's m log2(m)^2 / 4 compare-exchanges of W words each run
// in shared memory, so device memory sees each row once in and once out.
//
// Design.
// K2a: the TPU kernel takes a (64, m) block of groups into VMEM, marks run
// starts by comparing each lane with its rolled neighbour and takes the
// next start by a log2(m)-step suffix-min.  Here a block of RL_THREADS
// threads takes RL_THREADS / m whole groups when m <= RL_THREADS, one
// element a thread, or one group when m is larger, walked in chunks of
// RL_THREADS from the last to the first with the running minimum carried
// from the chunks after it.  The suffix-min is a log-step scan in shared
// memory, confined to a group by the index guard, so any m works.
// K2b/K2c: the TPU kernel runs a bitonic network along the lane (K2b) or
// sublane (K2c) axis of a VMEM block with rolls, comparing word 0 only.
// Here a block loads gpb whole groups (gpb * m >= MIN_ROWS rows, all W
// planes) into dynamic shared memory, sorts each by ALL W words with the
// all-ascending bitonic network of csrc/sort.cu (the first stage of a
// level pairs a row with its mirror), and so gives fully sorted groups
// that equal a stable sort's.  Run lengths then need no scan: a run start
// finds the end of its run by a binary search for the first greater row
// in its group.  The load and store walk the groups in the order in which
// neighbouring threads touch neighbouring addresses: element-major for
// strided columns (K2c), group-major for contiguous groups (K2b).  Over
// 48 KB of shared memory the launch needs cudaFuncSetAttribute first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t SENTINEL = 0x7FFFFFFFFFFFFFFFLL;
constexpr int RL_THREADS = 256;
constexpr int SORT_THREADS = 512;
constexpr int MIN_ROWS = 2048;                 // rows a sort block takes at least
constexpr int SMEM_MAX = 232448;               // 227 KB: a block's shared memory

struct Planes {
  const int64_t* w[4];
};
struct OutPlanes {
  int64_t* w[4];
};

template <int W>
__device__ __forceinline__ bool rows_differ(const Planes& pl, int64_t a,
                                            int64_t b) {
  bool ne = false;
#pragma unroll
  for (int q = 0; q < W; ++q) ne |= __ldg(pl.w[q] + a) != __ldg(pl.w[q] + b);
  return ne;
}

template <int W>
__global__ void __launch_bounds__(RL_THREADS)
run_lengths_kernel(Planes pl, int64_t G, int m, int gpb,
                   int32_t* __restrict__ counts) {
  __shared__ int sp[RL_THREADS];
  const int tid = threadIdx.x;
  if (m <= RL_THREADS) {
    // gpb = RL_THREADS / m whole groups, one element a thread
    const int q = tid / m, i = tid - q * m;
    const int64_t g = (int64_t)blockIdx.x * gpb + q;
    const bool active = q < gpb && g < G;
    const int64_t e = g * m + i;
    bool start = false, live = false;
    if (active) {
      start = i == 0 || rows_differ<W>(pl, e, e - 1);
      live = __ldg(pl.w[0] + e) != SENTINEL;
    }
    sp[tid] = start ? i : m;
    __syncthreads();
    for (int d = 1; d < m; d <<= 1) {          // sp[t] = min over [i, i + 2d)
      const int v = sp[tid];
      const int u = (active && i + d < m) ? sp[tid + d] : m;
      __syncthreads();
      sp[tid] = min(v, u);
      __syncthreads();
    }
    if (active) {
      const int next = i + 1 < m ? sp[tid + 1] : m;
      counts[e] = (start && live) ? next - i : 0;
    }
    return;
  }
  // one group, in chunks of RL_THREADS from the last to the first
  const int64_t base = (int64_t)blockIdx.x * m;
  int carry = m;                               // the first start past the chunk
  for (int c0 = ((m - 1) / RL_THREADS) * RL_THREADS; c0 >= 0;
       c0 -= RL_THREADS) {
    const int i = c0 + tid;
    const bool active = i < m;
    const int64_t e = base + i;
    bool start = false, live = false;
    if (active) {
      start = i == 0 || rows_differ<W>(pl, e, e - 1);
      live = __ldg(pl.w[0] + e) != SENTINEL;
    }
    sp[tid] = start ? i : m;
    __syncthreads();
    for (int d = 1; d < RL_THREADS; d <<= 1) {
      const int v = sp[tid];
      const int u = tid + d < RL_THREADS ? sp[tid + d] : m;
      __syncthreads();
      sp[tid] = min(v, u);
      __syncthreads();
    }
    if (active) {
      const int next = min(tid + 1 < RL_THREADS ? sp[tid + 1] : m, carry);
      counts[e] = (start && live) ? next - i : 0;
    }
    const int chunk_min = sp[0];
    __syncthreads();                           // sp is rewritten next chunk
    carry = min(carry, chunk_min);
  }
}

// row a > row b of the shared-memory tile, lexicographically
template <int W>
__device__ __forceinline__ bool tile_gt(const int64_t* s, int rows, int a,
                                        int b) {
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int64_t x = s[q * rows + a], y = s[q * rows + b];
    if (x != y) return x > y;
  }
  return false;
}

template <int W>
__global__ void __launch_bounds__(SORT_THREADS)
grouped_sort_kernel(Planes in, OutPlanes out, int32_t* __restrict__ counts,
                    int64_t G, int m, int log_half, int gpb,
                    int64_t elem_stride, int64_t group_stride) {
  extern __shared__ __align__(16) int64_t s[];
  const int rows = gpb * m;
  const int64_t g0 = (int64_t)blockIdx.x * gpb;
  const int ng = (int)(G - g0 < gpb ? G - g0 : gpb);   // groups in the block
  // element-major walk for strided columns: neighbouring threads take
  // neighbouring groups, which lie side by side in memory
  const bool columns = group_stride == 1 && elem_stride != 1;
  auto place = [&](int t, int& q, int& i) {
    if (columns) {
      i = t / gpb;
      q = t - i * gpb;
    } else {
      q = t / m;
      i = t - q * m;
    }
  };

  for (int t = threadIdx.x; t < rows; t += SORT_THREADS) {
    int q, i;
    place(t, q, i);
    const int r = q * m + i;
    const int64_t e = i * elem_stride + (g0 + q) * group_stride;
#pragma unroll
    for (int w = 0; w < W; ++w)
      s[w * rows + r] = q < ng ? __ldg(in.w[w] + e) : SENTINEL;
  }
  __syncthreads();

  // all-ascending bitonic network inside each group
  const int half = m >> 1;
  for (int kk = 2; kk <= m; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const bool mirror = j == (kk >> 1);
      for (int p = threadIdx.x; p < rows / 2; p += SORT_THREADS) {
        const int q = p >> log_half;
        const int pp = p & (half - 1);
        const int off = pp & (j - 1);
        const int blk = (pp - off) << 1;
        const int lo = q * m + blk + off;
        const int hi = q * m + (mirror ? blk + 2 * j - 1 - off : blk + off + j);
        if (tile_gt<W>(s, rows, lo, hi)) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int64_t a = s[w * rows + lo];
            s[w * rows + lo] = s[w * rows + hi];
            s[w * rows + hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // counts: a run start's run ends at the first greater row of its group
  for (int t = threadIdx.x; t < rows; t += SORT_THREADS) {
    int q, i;
    place(t, q, i);
    if (q >= ng) continue;
    const int r = q * m + i;
    const int64_t e = i * elem_stride + (g0 + q) * group_stride;
    int cnt = 0;
    if (s[r] != SENTINEL && (i == 0 || tile_gt<W>(s, rows, r, r - 1))) {
      int lo = i + 1, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tile_gt<W>(s, rows, q * m + mid, r)) hi = mid;
        else lo = mid + 1;
      }
      cnt = lo - i;
    }
    counts[e] = cnt;
#pragma unroll
    for (int w = 0; w < W; ++w) out.w[w][e] = s[w * rows + r];
  }
}

template <int W>
int run_lengths_rows(Planes pl, int64_t G, int m, int32_t* counts,
                     cudaStream_t st) {
  const int gpb = m <= RL_THREADS ? RL_THREADS / m : 1;
  const int64_t blocks = (G + gpb - 1) / gpb;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  run_lengths_kernel<W><<<(unsigned)blocks, RL_THREADS, 0, st>>>(pl, G, m,
                                                                 gpb, counts);
  return (int)cudaGetLastError();
}

template <int W>
int grouped_sort_rows(Planes in, OutPlanes out, int32_t* counts, int64_t G,
                      int m, int64_t elem_stride, int64_t group_stride,
                      cudaStream_t st) {
  const int gpb = m < MIN_ROWS ? MIN_ROWS / m : 1;
  const size_t smem = (size_t)gpb * m * W * sizeof(int64_t);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_sort_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int log_half = 0;
  while ((1 << log_half) < (m >> 1)) ++log_half;
  const int64_t blocks = (G + gpb - 1) / gpb;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  grouped_sort_kernel<W><<<(unsigned)blocks, SORT_THREADS, smem, st>>>(
      in, out, counts, G, m, log_half, gpb, elem_stride, group_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// K2a. w0..w3: G * m int64 rows, group g at rows [g * m, (g + 1) * m),
// each group sorted (the first W planes used, the rest may be null);
// counts: G * m int32.  1 <= W <= 4, G >= 1, m >= 1.  Returns the launch's
// cudaError_t.
extern "C" int run_lengths_grouped_launch(const int64_t* w0, const int64_t* w1,
                                          const int64_t* w2, const int64_t* w3,
                                          int W, int64_t G, int m,
                                          int32_t* counts, void* stream) {
  Planes pl = {{w0, w1, w2, w3}};
  if (W < 1 || W > 4 || G < 1 || m < 1) return (int)cudaErrorInvalidValue;
  for (int q = 0; q < W; ++q)
    if (pl.w[q] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return run_lengths_rows<1>(pl, G, m, counts, st);
    case 2: return run_lengths_rows<2>(pl, G, m, counts, st);
    case 3: return run_lengths_rows<3>(pl, G, m, counts, st);
    default: return run_lengths_rows<4>(pl, G, m, counts, st);
  }
}

// K2b / K2c. in0..in3 -> out0..out3: G groups of m rows, element i of
// group g at i * elem_stride + g * group_stride (K2b: (1, m); K2c: (G,
// 1)); each group sorted ascending by all W words, and counts (int32, the
// same layout) of its runs.  m a power of two whose gpb-group tile fits a
// block's shared memory.  Returns the first failing call's cudaError_t.
extern "C" int grouped_sort_count_launch(
    const int64_t* in0, const int64_t* in1, const int64_t* in2,
    const int64_t* in3, int64_t* out0, int64_t* out1, int64_t* out2,
    int64_t* out3, int W, int64_t G, int m, int64_t elem_stride,
    int64_t group_stride, int32_t* counts, void* stream) {
  Planes in = {{in0, in1, in2, in3}};
  OutPlanes out = {{out0, out1, out2, out3}};
  if (W < 1 || W > 4 || G < 1 || m < 1 || (m & (m - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < W; ++q)
    if (in.w[q] == nullptr || out.w[q] == nullptr)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return grouped_sort_rows<1>(in, out, counts, G, m, elem_stride,
                                        group_stride, st);
    case 2: return grouped_sort_rows<2>(in, out, counts, G, m, elem_stride,
                                        group_stride, st);
    case 3: return grouped_sort_rows<3>(in, out, counts, G, m, elem_stride,
                                        group_stride, st);
    default: return grouped_sort_rows<4>(in, out, counts, G, m, elem_stride,
                                         group_stride, st);
  }
}
