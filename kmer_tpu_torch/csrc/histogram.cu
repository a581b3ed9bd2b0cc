// Weighted index histogram for Hopper (sm_90a): hist[idx[i]] += w[i] over
// a lane stream, for indices below 2^bits, bits <= 16, accumulated into
// an int64 histogram that stays on the device across batches.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/histogram.py
// `index_histogram_mxu` (entry of `dense_histogram_mxu` too).
//
// What bounds it: memory and atomics.  Each lane costs an 8-byte key and
// a 1-byte weight load; lanes of weight 0 (sentinels, later in-segment
// duplicates) stop there.  The TPU kernel builds bf16 one-hot matrices
// and multiplies them on its matrix unit, because a TPU has no fast
// scatter; Hopper has shared-memory atomics, so this is a privatised
// histogram instead:
//   - each block keeps a slice of at most 32,768 int32 bins (128 KB) in
//     dynamic shared memory; 2^16 bins take two slices, one per
//     blockIdx.y, and each slice's blocks read every lane;
//   - blocks walk the lanes with a grid-stride loop (neighbouring threads
//     on neighbouring lanes), adding each lane's weight to its bin with a
//     shared-memory atomicAdd;
//   - at the end each block adds its non-zero bins to the global int64
//     histogram with 64-bit atomicAdd.
// The TPU kernel carries its sum in VMEM across an in-order grid; here
// blocks run in any order and only meet in the global atomics.
//
// MODE 1 folds the HyperLogLog class of kmer_tpu/ops/sketch.py
// `hll_classes` into the load: the key's uint32 words (most significant
// first, words_per_key(k) of them) through the FNV-style combine and the
// murmur3 finaliser, bucket = the top b hash bits, rho = the leading-zero
// run of the other 32 - b bits plus one, capped at 31; the bin is
// bucket * 32 + rho.  On native uint32_t this is the TPU's wrap-around
// arithmetic bit for bit.  MODE 2 is MODE 1 for keys of 32 to 63 bases:
// each is loaded as its (hi, lo) pair (kmer_tpu_torch/ops/encode.py) and
// becomes its 2k-bit value hi * 4^(k - 31) + lo in a 128-bit register,
// whose 3 or 4 words are hashed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int SLICE = 32768;               // bins per block, 128 KB
constexpr int MAX_BLOCKS = 264;            // 2 x the 132 SMs of an H100

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t word) {
  return mix32((h ^ word) * 0x01000193u + 0x811C9DC5u);
}

// the bin of a key's hash h
__device__ __forceinline__ int64_t hll_bin(uint32_t h, int b) {
  const int width = 32 - b;                       // 21 <= width <= 31
  const uint32_t tail = h & ((1u << width) - 1u);
  const int rho = min(width - (32 - __clz(tail)) + 1, 31);
  return (int64_t)(h >> width) * 32 + rho;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int64_t* __restrict__ keys,
                 const int64_t* __restrict__ keys_lo,
                 const int8_t* __restrict__ weights, int64_t n, int bits,
                 int n_words, int lo_bits, int b,
                 unsigned long long* __restrict__ hist) {
  extern __shared__ int32_t bins[];
  const int64_t lo = (int64_t)blockIdx.y * SLICE;
  const int64_t rest = ((int64_t)1 << bits) - lo;
  const int nb = (int)(rest < SLICE ? rest : SLICE);
  for (int i = threadIdx.x; i < nb; i += THREADS) bins[i] = 0;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int w = __ldg(weights + i);
    if (w == 0) continue;
    const int64_t key = __ldg(keys + i);
    int64_t idx;
    if constexpr (MODE == 0) {
      idx = key;                                  // out of range: dropped
    } else if constexpr (MODE == 1) {
      uint32_t h = 0x9E3779B9u;
      if (n_words == 2) h = combine(h, (uint32_t)((uint64_t)key >> 32));
      idx = hll_bin(combine(h, (uint32_t)key), b);
    } else {                               // (hi, lo): the 2k-bit value
      uint64_t lo = (uint64_t)__ldg(keys_lo + i);
      if (lo_bits == 64) lo ^= 1ull << 63;     // the stored flip
      const unsigned __int128 v =
          ((unsigned __int128)(uint64_t)key << lo_bits) | lo;
      uint32_t h = 0x9E3779B9u;
      for (int j = n_words - 1; j >= 0; --j)
        h = combine(h, (uint32_t)(v >> (32 * j)));
      idx = hll_bin(h, b);
    }
    idx -= lo;
    if (idx >= 0 && idx < nb) atomicAdd(&bins[idx], w);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nb; i += THREADS) {
    const int32_t v = bins[i];
    if (v != 0)
      atomicAdd(hist + lo + i, (unsigned long long)(long long)v);
  }
}

template <int MODE>
int launch(const int64_t* keys, const int64_t* keys_lo, const int8_t* weights,
           int64_t n, int bits, int n_words, int lo_bits, int b,
           unsigned long long* hist, cudaStream_t st) {
  const int64_t n_bins = 1LL << bits;
  const int slices = (int)((n_bins + SLICE - 1) / SLICE);
  const int nb = (int)(n_bins < SLICE ? n_bins : SLICE);
  // at least max(nb, 8192) lanes a block, so the flush of a block's bins
  // stays below the lanes it adds
  const int64_t per_block = nb > 8192 ? nb : 8192;
  int64_t blocks = (n + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  const size_t smem = (size_t)nb * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(SLICE * sizeof(int32_t)));
  if (err != cudaSuccess) return (int)err;
  histogram_kernel<MODE><<<dim3((unsigned)blocks, slices), THREADS, smem,
                           st>>>(keys, keys_lo, weights, n, bits, n_words,
                                 lo_bits, b, hist);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: n int64 (indices, or k-mer keys when hll != 0); weights: n int8;
// hist: 2^bits int64, accumulated into.  hll != 0: bits = b + 5 with
// 1 <= b <= 11, and the bin of a key is its HLL class for a k-mer of k
// bases: 1 <= k <= 31 keys, or 32 <= k <= 63 (hi, lo) pairs with the lo
// plane in keys_lo.  Returns the launch's cudaError_t.
extern "C" int histogram_launch(const int64_t* keys, const int64_t* keys_lo,
                                const int8_t* weights, int64_t n, int bits,
                                int hll, int k, int b, int64_t* hist,
                                void* stream) {
  if (n < 1 || bits < 1 || bits > 16 ||
      (hll && (b < 1 || b > 11 || bits != b + 5 || k < 1 || k > 63 ||
               (k > 31) != (keys_lo != nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* h = reinterpret_cast<unsigned long long*>(hist);
  const int n_words = (2 * k + 1 + 31) / 32;
  const int lo_bits = k > 31 ? 2 * (k - 31) : 0;
  if (!hll) return launch<0>(keys, nullptr, weights, n, bits, 0, 0, 0, h, st);
  if (k <= 31) return launch<1>(keys, nullptr, weights, n, bits, n_words, 0, b,
                                h, st);
  return launch<2>(keys, keys_lo, weights, n, bits, n_words, lo_bits, b, h, st);
}
