"""Weighted index histogram into a device-resident int64 table, as one
hand-written Hopper kernel (csrc/histogram.cu) and its plain torch
version.

Counterpart of kmer_tpu/ops/pallas/histogram.py `index_histogram_mxu`
and `dense_histogram_mxu`: hist[idx] += weight over a lane stream, for
indices below 2**bits, bits <= 16.  kmer_tpu's weight is a 0/1 `valid`;
here it is any int8 weight, so the fused count step's (keys, counts)
feed it directly: a later in-segment duplicate and a sentinel lane carry
0, the first lane of a run its multiplicity, which gives the table
kmer_tpu's histogram of every valid lane gives.  Indices outside
[0, 2**bits) are dropped, as kmer_tpu's scatter drops them.

hll_class_histogram is the same kernel with the HyperLogLog class of
ops/sketch.hll_classes computed from each key as it is loaded: an int64
key of up to 31 bases, the (hi, lo) pair of a key of 32 to 63, or the
words64(k) int64 planes of a wider key (ops/encode.word_bases; at most
MAX_PLANES of them, the most the kernel's parameters carry).

Both accumulate into `out` ((2**bits,) int64, made zero when not given)
and dispatch on where their inputs lie: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise).  An empty stream
launches nothing.

The kernel holds one int32 copy of the bins across a thread-block
cluster's distributed shared memory; `plan` sizes its grid from the
lanes, the bins and the card's SM count, and `owner` says which block of
a cluster holds a bin.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..encode import key_planes, words64

SOURCE = "kmer_tpu_torch/csrc/histogram.cu"
REPLACES = "kmer_tpu/ops/pallas/histogram.py:110"
MAX_BITS = 16
# the most key planes a launch takes (csrc/histogram.cu MAX_PLANES, as
# csrc/sort.cu's): keys of up to 7440 bases
MAX_PLANES = 240
# the kernel's threads a block, and the lanes a thread takes an iteration
# in MODE 0 to 2 (MODE 3 takes one; csrc/histogram.cu)
THREADS = 512
LANES = 16
# the plan's choices, measured on an H100 (PERF.md): at most
# SMEM_TARGET bytes of bins a block, in clusters of at most MAX_CLUSTER
# blocks (larger clusters, and smaller blocks two or more an SM, lose
# more to remote atomics and to the flush than they gain); one block an
# SM; at least MIN_BLOCK_LANES lanes a block
SMEM_TARGET = 128 * 1024
MAX_CLUSTER = 2
MIN_BLOCK_LANES = 512
# int32 bins: a cluster's lanes (its chunk and < 32 unaligned ones) times
# the largest |weight| stay below 2**31
MAX_CLUSTER_LANES = (((1 << 31) - 1) // 128 - 32) // LANES * LANES
# calls that launched the kernel (the plain version on CPU tensors does
# not count)
launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "histogram.cu"),
                         "kmer_histogram", cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.histogram_launch.restype = i
        lib.histogram_launch.argtypes = [vp, i, vp, i64, i, i, i, i, vp, i,
                                         i, i64, vp]
        if lib.histogram_max_planes() != MAX_PLANES:
            raise RuntimeError(f"histogram.cu takes "
                               f"{lib.histogram_max_planes()} planes, this "
                               f"wrapper {MAX_PLANES}")
        lib.histogram_attributes.restype = i
        lib.histogram_attributes.argtypes = [i, i, ctypes.POINTER(i),
                                             ctypes.POINTER(i)]
        _lib = lib
    return _lib


class Plan(NamedTuple):
    """The kernel's grid: `clusters` clusters of `cluster` blocks, each
    cluster `chunk` lanes (a multiple of LANES); `smem` bytes of bins a
    block."""
    cluster: int
    clusters: int
    chunk: int
    smem: int


def plan(n: int, bits: int, sm_count: int) -> Plan:
    """The grid for n lanes into 2**bits bins on a card of sm_count SMs.

    The cluster is the fewest blocks, up to MAX_CLUSTER, whose share of
    the bins fits SMEM_TARGET.  The clusters give one block to each SM,
    but each block at least MIN_BLOCK_LANES lanes; and they are at least
    enough that no cluster takes over MAX_CLUSTER_LANES, so no int32 bin
    can overflow.  A chunk is the lanes over the clusters, rounded up to
    a multiple of LANES.  The flush adds each block's non-zero bins, at
    most its cluster's lanes, so it needs no cap of its own."""
    n_bins = 1 << bits
    cluster = 1
    while n_bins // cluster * 4 > SMEM_TARGET and cluster < MAX_CLUSTER:
        cluster *= 2
    clusters = min(max(1, sm_count // cluster),
                   -(-n // (cluster * MIN_BLOCK_LANES)))
    clusters = max(1, clusters, -(-n // MAX_CLUSTER_LANES))
    chunk = max(LANES, -(-n // clusters // LANES) * LANES)
    return Plan(cluster, max(1, -(-n // chunk)), chunk, n_bins // cluster * 4)


def owner(idx, bits: int, cluster: int):
    """(block of the cluster, bin in its shared memory) that holds bin
    idx: idx's top log2(cluster) bits XOR the next log2(cluster), and its
    low bits (csrc/histogram.cu `owner`)."""
    log_c = cluster.bit_length() - 1
    shift = bits - log_c
    return ((idx >> shift) ^ ((idx >> (shift - log_c)) & (cluster - 1)),
            idx & ((1 << shift) - 1))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attributes(mode: int, planes: int = 0) -> tuple[int, int]:
    """(registers a thread, local bytes) of the kernel's MODE `mode`: 0
    indices, 1 HLL classes of keys, 2 of (hi, lo) pairs, 3 of keys of
    `planes` planes (its body for 3 to 8 planes holds a key's words in
    registers; any other count takes the one that loads them in turn)."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = load().histogram_attributes(mode, planes, ctypes.byref(regs),
                                     ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"histogram kernel attributes: cudaError {rc}")
    return regs.value, local.value


def _out(out, bits: int, device) -> torch.Tensor:
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits must be in [1, {MAX_BITS}], got {bits}")
    if out is None:
        return torch.zeros(1 << bits, dtype=torch.int64, device=device)
    if (out.shape != (1 << bits,) or out.dtype != torch.int64
            or out.device != torch.device(device) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({1 << bits},) int64 "
                         f"tensor on {device}")
    return out


def index_histogram_ref(idx: torch.Tensor, weight: torch.Tensor, bits: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version: index_add_ of the int64 weights of the
    in-range lanes."""
    out = _out(out, bits, idx.device)
    idx, w = idx.reshape(-1), weight.reshape(-1).to(torch.int64)
    keep = (w != 0) & (idx >= 0) & (idx < (1 << bits))
    return out.index_add_(0, idx[keep], w[keep])


def hll_class_histogram_ref(keys, weight: torch.Tensor, *, k: int, b: int,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version: ops/sketch.hll_classes, then
    index_histogram_ref over the 2**(b + 5) classes."""
    from ..sketch import hll_classes
    w = weight.reshape(-1)
    live = w != 0
    if isinstance(keys, tuple):
        keys = tuple(p.reshape(-1)[live] for p in keys)
    else:
        keys = keys.reshape(-1)[live]
    return index_histogram_ref(hll_classes(keys, k, b), w[live], b + 5, out)


def _launch(keys, weight, bits, out, hll_k: int, b: int,
            grid: Plan | None = None) -> torch.Tensor:
    planes = key_planes(keys)
    out = _out(out, bits, planes[0].device)
    if (any(p.dtype != torch.int64 or p.shape != weight.shape
            or p.device != weight.device or not p.is_contiguous()
            for p in planes)
            or weight.dtype != torch.int8 or not weight.is_contiguous()):
        raise ValueError("keys and weight must be contiguous int64 and int8 "
                         "tensors of one shape on one device")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"the histogram kernel takes keys of at most "
                         f"{MAX_PLANES} planes, got {len(planes)}")
    n = weight.numel()
    if n == 0:
        return out
    lib = load()
    dev = weight.device
    if grid is None:
        grid = plan(n, bits, _sm_count(dev.index))
    ptrs = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
    with torch.cuda.device(dev):
        rc = lib.histogram_launch(
            ptrs, len(planes), weight.data_ptr(), n, bits, int(hll_k > 0),
            hll_k, b, out.data_ptr(), grid.cluster, grid.clusters,
            grid.chunk, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def index_histogram(idx: torch.Tensor, weight: torch.Tensor, bits: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """out[idx] += weight over the lanes of idx (int64, any shape) with
    weight (int8, the same shape); returns out ((2**bits,) int64)."""
    if idx.device.type == "cpu":
        return index_histogram_ref(idx, weight, bits, out)
    if idx.device.type != "cuda":
        raise ValueError(f"no index_histogram on {idx.device}")
    return _launch(idx, weight, bits, out, 0, 0)


def hll_class_histogram(keys, weight: torch.Tensor, *, k: int, b: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """out[hll_class(key)] += weight over k-mer keys (int64 for 1 <= k <=
    31, past 31 the tuple of words64(k) int64 planes: (hi, lo) up to 63)
    and int8 weights; returns out ((2**(b + 5),) int64), 1 <= b <= 11."""
    if not (1 <= b <= 11 and k >= 1 and (
            len(keys) == words64(k) if isinstance(keys, tuple)
            else k <= 31)):
        raise ValueError(f"HLL classes need 1 <= b <= 11 and keys of k >= 1 "
                         f"bases (a tuple of words64(k) planes past 31), got "
                         f"b={b}, k={k}")
    if weight.device.type == "cpu":
        return hll_class_histogram_ref(keys, weight, k=k, b=b, out=out)
    if weight.device.type != "cuda":
        raise ValueError(f"no hll_class_histogram on {weight.device}")
    return _launch(keys, weight, b + 5, out, k, b)


def histogram_from_tpu(hist) -> np.ndarray:
    """kmer_tpu's int32 dense or HLL histogram -> this port's int64 one
    (kmer_tpu's HLL cells saturate at 2**30; no cell here does)."""
    return np.asarray(hist).astype(np.int64)
