// Lexicographic multiset sort of W in {1, 2, 3, 4} int64 word planes for
// Hopper (sm_90a): the rows (w0[i], ..., w{W-1}[i]) sorted ascending with
// word 0 most significant, duplicates kept, in place.  Words compare as
// signed int64, so the all-INT64_MAX sentinel row sorts last.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/sort.py `sort_words_pallas`
// (`_chunk_sort_kernel`, `_chunk_merge_kernel` and the cross-chunk stage
// `_cross_chunk_stage` between them).
//
// What bounds it: memory.  A bitonic network over n = 2^m rows makes
// m(m+1)/2 compare-exchange stages; each stage whose distance is below
// the shared-memory tile runs inside one pass, every other stage is one
// pass over device memory that reads W words a row and writes the rows
// it swaps.  At n = 2^26 that is 120 passes where the least work is one
// read and one write.
//
// Design, the TPU's three parts in Hopper terms:
//   1. tile_kernel (full): a block loads a TILE-row tile into dynamic
//      shared memory (TILE * W * 8 bytes, 32-128 KB) and sorts it with
//      every level k = 2..TILE of the network;
//   2. global_stage_kernel: one compare-exchange stage at distance
//      j >= TILE, one pass over device memory, one pair a thread;
//   3. tile_kernel (tail): each level's stages j = TILE/2..1 in one
//      shared-memory pass.
// The network is the all-ascending form of bitonic sort: the first stage
// of level k pairs row i with its mirror in the k-block (i ^ (k - 1)),
// the later stages pair i with i + j, and every compare-exchange puts the
// smaller row first.  Rows past n are virtual +infinity rows: an
// ascending compare-exchange never moves one, so the pairs that touch
// them are skipped and n needs no padding to a power of two (the TPU
// pads the planes with sentinels).  Row indices are 64-bit throughout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;        // rows a block sorts in shared memory
constexpr int THREADS = 1024;     // TILE / 2 pairs: two a thread a stage
constexpr int GLOBAL_THREADS = 256;

struct Planes {
  int64_t* w[4];
};

// row a > row b, lexicographically
template <int W>
__device__ __forceinline__ bool row_gt(const int64_t (&a)[W],
                                       const int64_t (&b)[W]) {
#pragma unroll
  for (int q = 0; q < W; ++q) {
    if (a[q] != b[q]) return a[q] > b[q];
  }
  return false;
}

// the pair of stage (k, j) with pair index p: lo in the lower half of its
// 2j-block, hi its mirror in the k-block (first stage of a level, j = k/2)
// or lo + j
__device__ __forceinline__ void pair_of(int64_t p, int64_t j, bool mirror,
                                        int64_t& lo, int64_t& hi) {
  const int64_t off = p & (j - 1);
  const int64_t base = (p - off) << 1;
  lo = base + off;
  hi = mirror ? base + 2 * j - 1 - off : lo + j;
}

template <int W>
__device__ __forceinline__ void smem_exchange(int64_t* s, int lo, int hi) {
  int64_t a[W], b[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    a[q] = s[q * TILE + lo];
    b[q] = s[q * TILE + hi];
  }
  if (row_gt<W>(a, b)) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      s[q * TILE + lo] = b[q];
      s[q * TILE + hi] = a[q];
    }
  }
}

template <int W>
__device__ __forceinline__ void smem_stage(int64_t* s, int j, bool mirror) {
  for (int p = threadIdx.x; p < TILE / 2; p += THREADS) {
    int64_t lo, hi;
    pair_of(p, j, mirror, lo, hi);
    smem_exchange<W>(s, (int)lo, (int)hi);
  }
  __syncthreads();
}

// full: levels k = 2..TILE of the tile; tail: stages j = TILE/2..1
template <int W>
__global__ void __launch_bounds__(THREADS)
tile_kernel(Planes pl, int64_t n, int full) {
  extern __shared__ __align__(16) int64_t s[];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const int64_t g = base + i;
#pragma unroll
    for (int q = 0; q < W; ++q)
      s[q * TILE + i] = g < n ? pl.w[q][g] : INT64_MAX;
  }
  __syncthreads();
  if (full) {
    for (int k = 2; k <= TILE; k <<= 1) {
      smem_stage<W>(s, k >> 1, true);
      for (int j = k >> 2; j > 0; j >>= 1) smem_stage<W>(s, j, false);
    }
  } else {
    for (int j = TILE / 2; j > 0; j >>= 1) smem_stage<W>(s, j, false);
  }
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const int64_t g = base + i;
    if (g < n) {
#pragma unroll
      for (int q = 0; q < W; ++q) pl.w[q][g] = s[q * TILE + i];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(GLOBAL_THREADS)
global_stage_kernel(Planes pl, int64_t n, int64_t pairs, int64_t j,
                    int mirror) {
  const int64_t stride = (int64_t)gridDim.x * GLOBAL_THREADS;
  for (int64_t p = (int64_t)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
       p < pairs; p += stride) {
    int64_t lo, hi;
    pair_of(p, j, mirror != 0, lo, hi);
    if (hi >= n) continue;             // a virtual +infinity row: no move
    int64_t a[W], b[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      a[q] = pl.w[q][lo];
      b[q] = pl.w[q][hi];
    }
    if (row_gt<W>(a, b)) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        pl.w[q][lo] = b[q];
        pl.w[q][hi] = a[q];
      }
    }
  }
}

template <int W>
int sort_rows(Planes pl, int64_t n, cudaStream_t st) {
  const size_t smem = (size_t)TILE * W * sizeof(int64_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t tiles = (n + TILE - 1) / TILE;
  int64_t npow = TILE;
  while (npow < n) npow <<= 1;
  const int64_t pairs = npow / 2;
  const int64_t want = (pairs + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  const unsigned gblocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));

  tile_kernel<W><<<(unsigned)tiles, THREADS, smem, st>>>(pl, n, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int64_t k = 2 * TILE; k <= npow; k <<= 1) {
    for (int64_t j = k >> 1; j >= TILE; j >>= 1) {
      global_stage_kernel<W><<<gblocks, GLOBAL_THREADS, 0, st>>>(
          pl, n, pairs, j, j == (k >> 1));
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    tile_kernel<W><<<(unsigned)tiles, THREADS, smem, st>>>(pl, n, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// w0..w3: n int64 rows each (the first W used, the rest may be null),
// sorted in place on `stream`.  1 <= W <= 4, 1 <= n < 2^62.  Returns the
// first failing call's cudaError_t, or 0.
extern "C" int sort_words_launch(int64_t* w0, int64_t* w1, int64_t* w2,
                                 int64_t* w3, int W, int64_t n,
                                 void* stream) {
  Planes pl = {{w0, w1, w2, w3}};
  if (W < 1 || W > 4 || n < 1 || n > ((int64_t)1 << 62) ||
      (n + TILE - 1) / TILE > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < W; ++q)
    if (pl.w[q] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return sort_rows<1>(pl, n, st);
    case 2: return sort_rows<2>(pl, n, st);
    case 3: return sort_rows<3>(pl, n, st);
    default: return sort_rows<4>(pl, n, st);
  }
}
