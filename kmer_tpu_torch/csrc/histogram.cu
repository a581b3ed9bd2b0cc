// Weighted index histogram for Hopper (sm_90a): hist[idx[i]] += w[i] over
// a lane stream, for indices below 2^bits, bits <= 16, accumulated into
// an int64 histogram that stays on the device across batches.
//
// Replaces the TPU kernel kmer_tpu/ops/pallas/histogram.py
// `index_histogram_mxu` (entry of `dense_histogram_mxu` too).
//
// What bounds it: memory.  Each lane costs an 8-byte key (16 bytes for a
// (hi, lo) pair, 8 W for W planes) and a 1-byte weight; the histogram is 2^bits int64.  What
// holds it back on an H100 is atomics: about two clocks an SM for each
// shared-memory add, more for a remote one, and the flush's 64-bit adds
// at the L2's atomic rate (PERF.md).  The TPU kernel builds bf16 one-hot
// matrices and multiplies them on its matrix unit, because a TPU has no
// fast scatter; Hopper has shared-memory atomics and thread-block
// clusters, so this is a privatised histogram held in a cluster's
// distributed shared memory:
//   - one int32 copy of all 2^bits bins is spread over the C blocks of a
//     cluster (C = 1, 2, 4 or 8), 2^bits / C bins a block, so every lane
//     is read once whatever `bits` is.  A block adds a lane's weight to
//     the owning block's bins through cluster.map_shared_rank() and an
//     atomicAdd there.  The owner of bin idx is its top log2(C) bits
//     XOR the next log2(C) (`owner`), which spreads canonical k-mers,
//     whose top bases lean towards A, over the blocks;
//   - each cluster takes one contiguous chunk of the lanes, its blocks'
//     threads 16 consecutive lanes an iteration: the weights in one
//     16-byte load, the keys as eight longlong2, all issued before any
//     is used (no load waits on a weight's test).  Lanes before the
//     first 16-byte-aligned weight and after the last whole group of 16
//     go through a scalar head and tail in block 0;
//   - the flush: each block adds its non-zero bins to the histogram, with
//     a plain add when there is one cluster (the block alone owns them)
//     and a 64-bit atomicAdd when there are several.  A block's non-zero
//     bins are at most its cluster's live lanes, so the flush never
//     exceeds the lanes.  (A scratch of [clusters, 2^bits] int32 rows
//     summed by a second kernel measured slower at 76 of 78 grids.)
// The grid (C, the number of clusters, the chunk) comes from the wrapper's
// plan (kmer_tpu_torch/ops/kernels/histogram.py `plan`): one block an SM,
// a cluster of 2 only where one block cannot hold the bins in 128 KB (bits
// 16; measured on an H100, larger clusters and more blocks lose more to
// remote atomics and to the flush than they gain), and chunks small
// enough that no int32 bin can overflow (a cluster's lanes x 128 < 2^31).
// A cluster of one block is launched plainly and syncs with
// __syncthreads.
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
// whose 3 or 4 words are hashed.  MODE 3 is MODE 1 for keys of more than
// 63 bases, in W = words64(k) int64 planes (kmer_tpu_torch/ops/encode.py
// word_bases: 31 bases each, the rest, 1 to 32, in the last, whose top
// bit is flipped at 32): the planes travel by value as a struct of
// MAX_PLANES pointers (as in sort.cu; a second parameter that the other
// modes take at one pointer), and each of a key's W words is shifted
// into a 128-bit funnel that hands the hash every 32 bits as they
// complete, most significant first, so fewer than 96 bits of the 2k-bit
// value are ever held.  A key costs 8 W bytes of loads and a few dozen
// operations, so a `card` batch pays the latency of its loads and the
// fixed cost of zeroing and scanning each block's bins (which holds most
// of its time once the loads overlap: PERF.md).  MODE 3 therefore
// takes one lane a thread, consecutive threads on consecutive lanes (a
// warp's load of plane j is one run of 256 bytes, its weights one of 32),
// with no group of 16 and so no scalar head or tail; a thread issues its
// lane's weight and all of its W key loads before it uses the first
// (template PW = W for W = 3 to 8, registers for the words), and hashes
// the words, but adds nothing for a lane of weight 0.  Past 8 planes the
// words are loaded one after another, and only for a live lane.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int LANES = 16;               // lanes a thread takes an iteration
constexpr int MAX_SMEM = 232448;        // 227 KB, the most a block can have
// MODE 3's key planes, by value (a kernel's parameters hold 4 KB)
constexpr int MAX_PLANES = 240;
constexpr int WORD_BITS = 62;           // a full plane: 31 bases

struct Params {
  const int64_t* keys;
  const int64_t* keys_lo;
  const int8_t* weights;
  int64_t n;          // lanes
  int64_t head;       // lanes before the first 16-byte-aligned weight
  int64_t body_end;   // end of the whole groups of 16 lanes
  int64_t chunk;      // lanes a cluster (a multiple of 16)
  int bits, log_c, shift;   // 2^bits bins, 2^log_c blocks a cluster,
                            // 2^shift bins a block
  int n_words, lo_bits, b;  // HLL: words hashed, lo's bits, bucket bits
  int keys_vec;       // the key planes are 16-byte aligned at `head`
  unsigned long long* hist;
  int n_planes;       // MODE 3: key planes
  int last_bits;      // MODE 3: the last plane's value bits (64: flipped)
  int pad;            // MODE 3: zero bits above the key in its words
};

// MODE 3's key planes, a second by-value parameter sized by the mode, so
// the other modes launch with the parameters they always had
template <int MODE>
struct Planes {
  const int64_t* w[MODE == 3 ? MAX_PLANES : 1];
};

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

// MODE 3's funnel over a key's words, plane by plane (PW planes, or
// p.n_planes at PW = 0).  `held` holds the bits not yet hashed in its
// low `pending` bits (with `pad` zero bits above the key to start with);
// each plane's 64 bits are ORed in after a shift by its value bits, and
// each complete 32-bit word goes to the hash, most significant first.  A
// word waits while the next plane's bits above its value bits (64 minus
// them: 2 for a full plane) could still reach it, so the words are those
// of the OR of every plane at its place (ops/sketch.key_words), whatever
// a lane holds; pending stays below 96.
struct Funnel {
  uint32_t h = 0x9E3779B9u;
  unsigned __int128 held = 0;
  int pending;
  __device__ explicit Funnel(int pad) : pending(pad) {}

  template <int PW>
  __device__ __forceinline__ void push(uint64_t v, int j, const Params& p) {
    const int last = (PW > 0 ? PW : p.n_planes) - 1;
    int bits = WORD_BITS, reach = 0;    // reach: the next plane's spill
    if (j == last) {
      bits = p.last_bits;
      if (bits == 64) v ^= 1ull << 63;         // the stored flip
    } else {
      reach = 64 - (j + 1 == last ? p.last_bits : WORD_BITS);
    }
    held = (held << bits) | v;
    pending += bits;
    while (pending >= 32 + reach) {
      pending -= 32;
      h = combine(h, (uint32_t)(held >> pending));
    }
  }
};

// MODE 3: the bin of a key whose PW words are in registers
template <int PW>
__device__ __forceinline__ int64_t plane_bin(const uint64_t (&v)[PW],
                                             const Params& p) {
  Funnel f(p.pad);
#pragma unroll
  for (int j = 0; j < PW; ++j) f.push<PW>(v[j], j, p);
  return hll_bin(f.h, p.b);
}

// MODE 3 past 8 planes: the bin of lane i's key, its words loaded one
// after another
__device__ __forceinline__ int64_t plane_bin(int64_t i, const Params& p,
                                             const Planes<3>& planes) {
  Funnel f(p.pad);
  for (int j = 0; j < p.n_planes; ++j)
    f.push<0>((uint64_t)__ldg(planes.w[j] + i), j, p);
  return hll_bin(f.h, p.b);
}

// the bin of one lane (MODE 0: the key itself, maybe out of range)
template <int MODE>
__device__ __forceinline__ int64_t lane_bin(int64_t key, int64_t key_lo,
                                            const Params& p) {
  if constexpr (MODE == 0) {
    return key;
  } else if constexpr (MODE == 1) {
    uint32_t h = 0x9E3779B9u;
    if (p.n_words == 2) h = combine(h, (uint32_t)((uint64_t)key >> 32));
    return hll_bin(combine(h, (uint32_t)key), p.b);
  } else {                                 // (hi, lo): the 2k-bit value
    uint64_t lo = (uint64_t)key_lo;
    if (p.lo_bits == 64) lo ^= 1ull << 63;     // the stored flip
    const unsigned __int128 v =
        ((unsigned __int128)(uint64_t)key << p.lo_bits) | lo;
    uint32_t h = 0x9E3779B9u;
    for (int j = p.n_words - 1; j >= 0; --j)
      h = combine(h, (uint32_t)(v >> (32 * j)));
    return hll_bin(h, p.b);
  }
}

// the block of a cluster that owns bin idx: its top log_c bits XOR the
// next log_c; the bin sits at idx's low `shift` bits in that block
__device__ __forceinline__ int owner(int64_t idx, const Params& p) {
  const int mask = (1 << p.log_c) - 1;
  return (int)(idx >> p.shift) ^ ((int)(idx >> (p.shift - p.log_c)) & mask);
}

// out-of-range lanes and lanes of weight 0 are dropped
__device__ __forceinline__ void add(cg::cluster_group& cluster, int32_t* bins,
                                    int64_t idx, int w, const Params& p) {
  if (w == 0 || ((uint64_t)idx >> p.bits) != 0) return;
  const int at = (int)idx & ((1 << p.shift) - 1);
  if (p.log_c == 0) {
    atomicAdd(bins + at, w);
  } else {
    atomicAdd(cluster.map_shared_rank(bins, owner(idx, p)) + at, w);
  }
}

// every block's bins are in place: the block's own threads, or the
// cluster's when bins are spread over it
__device__ __forceinline__ void sync_bins(cg::cluster_group& cluster,
                                          int log_c) {
  if (log_c == 0)
    __syncthreads();
  else
    cluster.sync();
}

template <int MODE>
__device__ __forceinline__ void scalar_lane(cg::cluster_group& cluster,
                                            int32_t* bins, int64_t i,
                                            const Params& p) {
  const int w = __ldg(p.weights + i);
  if (w == 0) return;
  add(cluster, bins,
      lane_bin<MODE>(__ldg(p.keys + i), MODE == 2 ? __ldg(p.keys_lo + i) : 0,
                     p),
      w, p);
}

// MODE 3: lanes lo, lo + step, ... below hi, one a thread.  The weight
// and every word are loaded before any is used (PW > 0); the words are
// hashed whatever the weight, so that no load waits on its test.
template <int PW>
__device__ __forceinline__ void plane_lanes(cg::cluster_group& cluster,
                                            int32_t* bins, int64_t lo,
                                            int64_t hi, int64_t step,
                                            const Params& p,
                                            const Planes<3>& planes) {
  for (int64_t i = lo; i < hi; i += step) {
    const int w = __ldg(p.weights + i);
    if constexpr (PW > 0) {
      uint64_t v[PW];
#pragma unroll
      for (int j = 0; j < PW; ++j) v[j] = (uint64_t)__ldg(planes.w[j] + i);
      const int64_t bin = plane_bin<PW>(v, p);
      add(cluster, bins, bin, w, p);
    } else if (w != 0) {
      add(cluster, bins, plane_bin(i, p, planes), w, p);
    }
  }
}

// two blocks an SM at most 64 registers a thread; a (hi, lo) pair's 16
// lanes take 64 for their keys alone.  PW: MODE 3's planes when they are
// 3 to 8, else 0
template <int MODE, int PW = 0>
__global__ void __launch_bounds__(THREADS, MODE == 2 ? 1 : 2)
histogram_kernel(const Params p, const Planes<MODE> planes) {
  extern __shared__ int4 bins4[];
  int32_t* bins = reinterpret_cast<int32_t*>(bins4);
  cg::cluster_group cluster = cg::this_cluster();
  const int log_c = p.log_c;
  const int rank = (int)cluster.block_rank();
  const int nb = 1 << p.shift;
  for (int i = threadIdx.x; i < nb / 4; i += THREADS)
    bins4[i] = make_int4(0, 0, 0, 0);
  for (int i = nb / 4 * 4 + threadIdx.x; i < nb; i += THREADS) bins[i] = 0;
  sync_bins(cluster, log_c);              // every block's bins are zero

  const int64_t g = blockIdx.x >> log_c;  // the cluster
  if constexpr (MODE == 3) {
    const int64_t lo = g * p.chunk;
    plane_lanes<PW>(cluster, bins,
                    lo + (int64_t)rank * THREADS + threadIdx.x,
                    min(lo + p.chunk, p.n), (int64_t)THREADS << log_c, p,
                    planes);
  } else {
    const int64_t lo = p.head + g * p.chunk;
    const int64_t hi = min(lo + p.chunk, p.body_end);
    const int64_t step = ((int64_t)THREADS * LANES) << log_c;
    for (int64_t i = lo + ((int64_t)rank * THREADS + threadIdx.x) * LANES;
         i < hi; i += step) {
      const int4 wv = __ldg(reinterpret_cast<const int4*>(p.weights + i));
      int64_t key[LANES], key_lo[LANES];
      if (p.keys_vec) {
#pragma unroll
        for (int j = 0; j < LANES / 2; ++j) {
          const longlong2 v =
              __ldg(reinterpret_cast<const longlong2*>(p.keys + i) + j);
          key[2 * j] = v.x;
          key[2 * j + 1] = v.y;
          if constexpr (MODE == 2) {
            const longlong2 u =
                __ldg(reinterpret_cast<const longlong2*>(p.keys_lo + i) + j);
            key_lo[2 * j] = u.x;
            key_lo[2 * j + 1] = u.y;
          }
        }
      } else {                  // keys not aligned with the weights
#pragma unroll
        for (int j = 0; j < LANES; ++j) {
          key[j] = __ldg(p.keys + i + j);
          if constexpr (MODE == 2) key_lo[j] = __ldg(p.keys_lo + i + j);
        }
      }
      const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y,
                                 (uint32_t)wv.z, (uint32_t)wv.w};
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        const int w = (int8_t)(words[l >> 2] >> (8 * (l & 3)));
        if (w != 0)
          add(cluster, bins,
              lane_bin<MODE>(key[l], MODE == 2 ? key_lo[l] : 0, p), w, p);
      }
    }
    if (blockIdx.x == 0) {                // the scalar head and tail
      const int64_t t = threadIdx.x;
      const int64_t i = t < p.head ? t : p.body_end + (t - p.head);
      if (i < p.n) scalar_lane<MODE>(cluster, bins, i, p);
    }
  }
  sync_bins(cluster, log_c);  // every lane is in; no bins are a target

  // bin i of this block is bin ((rank ^ its next log_c bits) << shift) | i
  // of the histogram (`owner` inverted)
  const int mask = (1 << log_c) - 1;
  const bool single = gridDim.x == (1u << log_c);
  for (int i = threadIdx.x; i < nb; i += THREADS) {
    const int32_t v = bins[i];
    if (v == 0) continue;
    const int64_t idx =
        ((int64_t)(rank ^ ((i >> (p.shift - log_c)) & mask)) << p.shift) | i;
    if (single)                           // this block alone owns idx
      p.hist[idx] += (unsigned long long)(long long)v;
    else
      atomicAdd(p.hist + idx, (unsigned long long)(long long)v);
  }
}

template <int MODE, int PW = 0>
int launch(const Params& p, const Planes<MODE>& planes, int clusters,
           cudaStream_t st) {
  const int smem = (int)(sizeof(int32_t) << p.shift);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        histogram_kernel<MODE, PW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.log_c == 0) {              // one block a cluster: a plain launch
    histogram_kernel<MODE, PW><<<(unsigned)clusters, THREADS, smem, st>>>(
        p, planes);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters << p.log_c);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << p.log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, histogram_kernel<MODE, PW>, p, planes);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// planes: n_planes device pointers to n int64 each (indices, or k-mer
// keys when hll != 0); weights: n int8; hist: 2^bits int64, accumulated
// into.  hll != 0: bits = b + 5 with 1 <= b <= 11, and the bin of a key
// is its HLL class for a k-mer of k bases: 1 <= k <= 31 one plane,
// 32 <= k <= 63 the (hi, lo) pair, k > 63 words64(k) <= MAX_PLANES
// planes.  The grid: clusters of `cluster` blocks (1, 2, 4 or 8, with
// bits >= 2 log2(cluster)), `clusters` of them, `chunk` lanes each (a
// multiple of 16, clusters x chunk >= n, (chunk + 32) x 128 < 2^31).
// Returns the launch's cudaError_t.
extern "C" int histogram_launch(const int64_t* const* planes, int n_planes,
                                const int8_t* weights, int64_t n, int bits,
                                int hll, int k, int b, int64_t* hist,
                                int cluster, int clusters, int64_t chunk,
                                void* stream) {
  int log_c = 0;
  while ((1 << log_c) < cluster) ++log_c;
  const int want_planes =
      !hll || k <= 31 ? 1 : (k <= 63 ? 2 : (k - 2) / 31 + 1);
  if (n < 1 || bits < 1 || bits > 16 || planes == nullptr ||
      n_planes != want_planes || n_planes > MAX_PLANES ||
      (hll && (b < 1 || b > 11 || bits != b + 5 || k < 1)) ||
      cluster < 1 || cluster > 8 || (1 << log_c) != cluster ||
      bits < 2 * log_c || clusters < 1 || chunk < 16 || chunk % 16 ||
      (double)clusters * (double)chunk < (double)n ||
      (chunk + 32) * 128 >= (1LL << 31) ||
      ((int64_t)sizeof(int32_t) << (bits - log_c)) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.keys = planes[0];
  p.keys_lo = n_planes == 2 ? planes[1] : nullptr;
  p.weights = weights;
  p.n = n;
  p.head = (int64_t)((16 - (reinterpret_cast<uintptr_t>(weights) & 15)) & 15);
  if (p.head > n) p.head = n;
  p.body_end = p.head + (n - p.head) / LANES * LANES;
  p.chunk = chunk;
  p.bits = bits;
  p.log_c = log_c;
  p.shift = bits - log_c;
  p.n_words = (2 * k + 1 + 31) / 32;
  p.lo_bits = k > 31 && k <= 63 ? 2 * (k - 31) : 0;
  p.b = b;
  p.keys_vec = (reinterpret_cast<uintptr_t>(p.keys + p.head) & 15) == 0 &&
               (p.keys_lo == nullptr ||
                (reinterpret_cast<uintptr_t>(p.keys_lo + p.head) & 15) == 0);
  p.hist = reinterpret_cast<unsigned long long*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!hll) return launch<0>(p, {}, clusters, st);
  if (k <= 31) return launch<1>(p, {}, clusters, st);
  if (k <= 63) return launch<2>(p, {}, clusters, st);
  const int rest = k - 31 * (n_planes - 1);         // 1 to 32
  p.n_planes = n_planes;
  p.last_bits = rest == 32 ? 64 : 2 * rest;
  p.pad = 32 * p.n_words - 2 * k;                   // 1 to 32
  Planes<3> w = {};
  for (int j = 0; j < n_planes; ++j) w.w[j] = planes[j];
  switch (n_planes) {
    case 3: return launch<3, 3>(p, w, clusters, st);
    case 4: return launch<3, 4>(p, w, clusters, st);
    case 5: return launch<3, 5>(p, w, clusters, st);
    case 6: return launch<3, 6>(p, w, clusters, st);
    case 7: return launch<3, 7>(p, w, clusters, st);
    case 8: return launch<3, 8>(p, w, clusters, st);
    default: return launch<3>(p, w, clusters, st);
  }
}

extern "C" int histogram_max_planes() { return MAX_PLANES; }

// registers a thread and local (spill) bytes of the histogram kernel's
// MODE 0, 1, 2 or 3 (MODE 3 for keys of `planes` planes); returns the
// cudaError_t
namespace {
template <int MODE, int PW = 0>
cudaError_t attributes_of(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, histogram_kernel<MODE, PW>);
}
}  // namespace

extern "C" int histogram_attributes(int mode, int planes, int* regs,
                                    int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (mode == 3 && planes >= 3 && planes <= 8 ? 10 + planes : mode) {
    case 0: err = attributes_of<0>(&a); break;
    case 1: err = attributes_of<1>(&a); break;
    case 2: err = attributes_of<2>(&a); break;
    case 3: err = attributes_of<3>(&a); break;
    case 13: err = attributes_of<3, 3>(&a); break;
    case 14: err = attributes_of<3, 4>(&a); break;
    case 15: err = attributes_of<3, 5>(&a); break;
    case 16: err = attributes_of<3, 6>(&a); break;
    case 17: err = attributes_of<3, 7>(&a); break;
    case 18: err = attributes_of<3, 8>(&a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
