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
key of up to 31 bases, or the (hi, lo) pair of a key of 32 to 63.

Both accumulate into `out` ((2**bits,) int64, made zero when not given)
and dispatch on where their inputs lie: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise).  An empty stream
launches nothing.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..encode import key_planes

SOURCE = "kmer_tpu_torch/csrc/histogram.cu"
REPLACES = "kmer_tpu/ops/pallas/histogram.py:110"
MAX_BITS = 16
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
        lib.histogram_launch.argtypes = [vp, vp, vp, i64, i, i, i, i, vp, vp]
        _lib = lib
    return _lib


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


def _launch(keys, weight, bits, out, hll_k: int, b: int) -> torch.Tensor:
    planes = key_planes(keys)
    out = _out(out, bits, planes[0].device)
    if (any(p.dtype != torch.int64 or p.shape != weight.shape
            or p.device != weight.device or not p.is_contiguous()
            for p in planes)
            or weight.dtype != torch.int8 or not weight.is_contiguous()):
        raise ValueError("keys and weight must be contiguous int64 and int8 "
                         "tensors of one shape on one device")
    n = weight.numel()
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(weight.device):
        rc = lib.histogram_launch(planes[0].data_ptr(),
                                  planes[1].data_ptr() if len(planes) == 2
                                  else None, weight.data_ptr(), n, bits,
                                  int(hll_k > 0), hll_k, b, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
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
    31, the (hi, lo) pair for 32 <= k <= 63) and int8 weights; returns out
    ((2**(b + 5),) int64), 1 <= b <= 11."""
    if not (1 <= b <= 11 and 1 <= k <= 63
            and isinstance(keys, tuple) == (k > 31)):
        raise ValueError(f"HLL classes need 1 <= b <= 11 and 1 <= k <= 63 "
                         f"(a (hi, lo) pair past 31), got b={b}, k={k}")
    if weight.device.type == "cpu":
        return hll_class_histogram_ref(keys, weight, k=k, b=b, out=out)
    if weight.device.type != "cuda":
        raise ValueError(f"no hll_class_histogram on {weight.device}")
    return _launch(keys, weight, b + 5, out, k, b)


def histogram_from_tpu(hist) -> np.ndarray:
    """kmer_tpu's int32 dense or HLL histogram -> this port's int64 one
    (kmer_tpu's HLL cells saturate at 2**30; no cell here does)."""
    return np.asarray(hist).astype(np.int64)
