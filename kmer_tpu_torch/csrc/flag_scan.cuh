// Warp and block primitives over one flag a lane, shared by
// csrc/compact.cu (K4: "is this lane live", each live lane's rank among
// the live lanes), the run lengths of csrc/grouped_count.cu (K2a and
// K2b's warp body: "does a run start here", each start's distance to the
// next start) and csrc/merge_reduce.cu (the device merge's run totals:
// "does a run start here", each run's sum).
//
// - ballot_rank: a warp ballot of a flag and the number of set flags on
//   the lanes below this one (__popc of the ballot under %lanemask_lt);
// - block_exclusive_scan: the exclusive prefix of per-thread counts over
//   the block and the block's total, by a warp shuffle scan and one pass
//   over the per-warp totals in shared memory, behind one barrier;
// - the next set flag after a position: inside a thread's own bits
//   (next_bit_after), then across the warp (warp_next: __ffs of the ballot
//   past this lane, the value fetched from that lane by a shuffle), then
//   across the warps of the block (block_next: the least of the per-warp
//   firsts after this warp in shared memory, at most 32 of them).
// - run pairs (RunSum: runs started, sum since the last start) under the
//   segmented-sum operator run_combine, (a, s) + (b, t) = (a + b, b > 0 ?
//   t : s + t), which is associative with (0, 0) its identity: a warp's
//   inclusive scan (warp_inclusive_run_scan), the block's exclusive scan
//   (block_exclusive_run_scan) and the total of a warp whose HIGHER lanes
//   come first (warp_run_total_reversed: a look-back window, lane i the
//   tile i before the nearest).
//
// Every function is called by all 32 lanes of a warp (the block scans by
// every thread of the block).
//
// The build helper (kmer_tpu_torch/utils/build.py) rebuilds a kernel when
// this header is newer than its library.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace flag_scan {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned lanemask_gt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_gt;" : "=r"(m));
  return m;
}

// the ballot of `flag` over the warp, and how many lanes below this one
// set it
__device__ __forceinline__ int ballot_rank(bool flag, unsigned& ballot) {
  ballot = __ballot_sync(FULL, flag);
  return __popc(ballot & lanemask_lt());
}

// inclusive scan of v over the warp
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// sum of v over the warp, to every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// Exclusive prefix of v over the block's threads in thread order, and the
// block's total in `total`.  warp_tot: WARPS ints of shared memory, which
// the caller may rewrite only after another barrier.
template <int WARPS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot,
                                                    int& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int below = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = warp_tot[w];
    below += w < warp ? t : 0;
    total += t;
  }
  return below + inc - v;
}

// the lowest set bit of `bits` above bit j, or -1
__device__ __forceinline__ int next_bit_after(unsigned bits, int j) {
  const unsigned above = j >= 31 ? 0u : bits & (FULL << (j + 1));
  return above ? __ffs(above) - 1 : -1;
}

// `first` of the nearest lane above this one whose `has` is set, or
// `none` when no lane above has it
template <typename T>
__device__ __forceinline__ T warp_next(bool has, T first, T none) {
  const unsigned later = __ballot_sync(FULL, has) & lanemask_gt();
  const int src = later ? __ffs(later) - 1 : (int)(threadIdx.x % 32);
  const T v = __shfl_sync(FULL, first, src);
  return later ? v : none;
}

// `first` of the lowest lane of the warp whose `has` is set (the same on
// every lane), or `none`
template <typename T>
__device__ __forceinline__ T warp_first(bool has, T first, T none) {
  const unsigned any = __ballot_sync(FULL, has);
  const T v = __shfl_sync(FULL, first, any ? __ffs(any) - 1 : 0);
  return any ? v : none;
}

// the least of firsts[warp + 1 .. count - 1]: the first set flag past this
// warp, from the per-warp firsts in shared memory (count <= 33: the warps
// of a block and one entry past the block), or `none`
template <typename T>
__device__ __forceinline__ T block_next(const T* firsts, int warp, int count,
                                        T none) {
  T v = none;
  for (int q = warp + 1; q < count; ++q) v = firsts[q] < v ? firsts[q] : v;
  return v;
}

// (runs started, sum of the values since the last start)
struct RunSum {
  int runs;
  int64_t sum;
};

// x then y: y's sum alone when a run starts in y, else x's and y's
__device__ __forceinline__ RunSum run_combine(RunSum x, RunSum y) {
  return {x.runs + y.runs, y.runs > 0 ? y.sum : x.sum + y.sum};
}

// inclusive scan of v over the warp, lane 0 first
__device__ __forceinline__ RunSum warp_inclusive_run_scan(RunSum v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const RunSum u = {__shfl_up_sync(FULL, v.runs, d),
                      __shfl_up_sync(FULL, v.sum, d)};
    if (lane >= d) v = run_combine(u, v);
  }
  return v;
}

// v of lanes 31, 30, ..., 0 combined in that order, to every lane
__device__ __forceinline__ RunSum warp_run_total_reversed(RunSum v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const RunSum u = {__shfl_down_sync(FULL, v.runs, d),
                      __shfl_down_sync(FULL, v.sum, d)};
    if (lane + d < 32) v = run_combine(u, v);
  }
  return {__shfl_sync(FULL, v.runs, 0), __shfl_sync(FULL, v.sum, 0)};
}

// Exclusive prefix of v over the block's threads in thread order, and the
// block's total in `total`.  warp_tot: WARPS pairs of shared memory, which
// the caller may rewrite only after another barrier.
template <int WARPS>
__device__ __forceinline__ RunSum block_exclusive_run_scan(RunSum v,
                                                           RunSum* warp_tot,
                                                           RunSum& total) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const RunSum inc = warp_inclusive_run_scan(v);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  RunSum below = {0, 0};
  total = {0, 0};
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const RunSum t = warp_tot[w];
    if (w < warp) below = run_combine(below, t);
    total = run_combine(total, t);
  }
  RunSum in_warp = {__shfl_up_sync(FULL, inc.runs, 1),
                    __shfl_up_sync(FULL, inc.sum, 1)};
  if (lane == 0) in_warp = {0, 0};
  return run_combine(below, in_warp);
}

}  // namespace flag_scan
