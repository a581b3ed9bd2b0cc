"""Native multithreaded (key, count) pair aggregation binding.

KmerTable.from_pairs funnels every host merge through here for large
inputs: a bucket-parallel sort-reduce in C++, compiled by path from
kmer_tpu/pipeline/native/aggregate.cpp (utils/build).  Below MIN_N pairs
the single-threaded numpy path in pipeline/table.py is faster and is
used instead.  The native output equals numpy's bit for bit (sorted
unique keys; int64 sums do not depend on order).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None

# below this the numpy path wins (thread start-up and ctypes overhead)
MIN_N = 1 << 16
# below this the numpy decode's fixed set-up wins
DECODE_MIN_N = 1 << 12

_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def load():
    """Load (building if needed) the native aggregator; raises if it
    cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    from ..utils.build import KMER_TPU_DIR, build_cdll
    lib = build_cdll(os.path.join(KMER_TPU_DIR, "pipeline", "native",
                                  "aggregate.cpp"), "kmer_agg")
    i, i64 = ctypes.c_int, ctypes.c_int64
    lib.aggregate_pairs.restype = i64
    lib.aggregate_pairs.argtypes = [_u64p, _i64p, i64, i, i, _u64p, _i64p]
    lib.decode_lines.restype = i
    lib.decode_lines.argtypes = [_u32p, i64, i, i, i, i, _u8p]
    lib.format_tsv.restype = i64
    lib.format_tsv.argtypes = [_u32p, _i64p, i64, i, i, i, _u8p, i64]
    _lib = lib
    return lib


def native_loaded() -> bool:
    return _lib is not None


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def aggregate_fused(fused_ls: list[np.ndarray], counts: np.ndarray
                    ) -> tuple[list[np.ndarray], np.ndarray] | None:
    """Aggregate from_pairs' fused-uint64 columns natively.

    fused_ls: 1 or 2 uint64 columns, LEAST significant first; counts:
    (n,) int64.  Returns (cols_ms, counts) -- unique keys ascending,
    columns MOST significant first -- or None when n < MIN_N (the numpy
    path is faster there) or the native call reports an error."""
    n = len(counts)
    if n < MIN_N or len(fused_ls) > 2:
        return None
    lib = load()
    nw = len(fused_ls)
    if nw == 1:
        keys = np.ascontiguousarray(fused_ls[0], np.uint64)
    else:
        keys = np.empty((n, 2), np.uint64)
        keys[:, 0] = fused_ls[1]       # most significant word first
        keys[:, 1] = fused_ls[0]
    counts = np.ascontiguousarray(counts, np.int64)
    out_k = np.empty_like(keys).reshape(n, nw)
    out_c = np.empty(n, np.int64)
    m = lib.aggregate_pairs(keys.ctypes.data_as(_u64p),
                            counts.ctypes.data_as(_i64p), n, nw, _threads(),
                            out_k.ctypes.data_as(_u64p),
                            out_c.ctypes.data_as(_i64p))
    if m < 0:
        return None            # bad arguments / out of memory: numpy path
    # copy the live prefix so the n-row scratch is not pinned by a view
    out_k = out_k[:m].copy()
    out_c = out_c[:m].copy()
    if nw == 1:
        return [out_k.reshape(-1)], out_c
    return [out_k[:, 0], out_k[:, 1]], out_c


def _check_words(words: np.ndarray, n_bases: int) -> np.ndarray | None:
    from ..ops.encode import words_per_key
    words = np.ascontiguousarray(words, np.uint32)
    if words.ndim != 2 or words.shape[1] != words_per_key(n_bases):
        return None
    return words


def decode_rows(words: np.ndarray, n_bases: int,
                newline: bool) -> np.ndarray | None:
    """(n, W) uint32 key words -> (n, n_bases [+1]) uint8 ASCII rows in
    one multithreaded pass; None for small or wrong-width inputs (the
    numpy decode in ops/encode handles those)."""
    n = len(words)
    words = _check_words(words, n_bases)
    if n < DECODE_MIN_N or words is None:
        return None
    lib = load()
    out = np.empty((n, n_bases + (1 if newline else 0)), np.uint8)
    rc = lib.decode_lines(words.ctypes.data_as(_u32p), n, words.shape[1],
                          n_bases, 1 if newline else 0, _threads(),
                          out.ctypes.data_as(_u8p))
    return out if rc == 0 else None


def format_tsv_rows(words: np.ndarray, counts: np.ndarray,
                    n_bases: int) -> bytes | None:
    """"BASES\\tCOUNT\\n" rendering of table rows in one multithreaded
    pass; None for small or wrong-width inputs (numpy renders those)."""
    n = len(counts)
    words = _check_words(words, n_bases)
    if n < DECODE_MIN_N or words is None:
        return None
    lib = load()
    counts = np.ascontiguousarray(counts, np.int64)
    cap = n * (n_bases + 22)       # bases, tab, sign, 19 digits, newline
    out = np.empty(cap, np.uint8)
    total = lib.format_tsv(words.ctypes.data_as(_u32p),
                           counts.ctypes.data_as(_i64p), n, words.shape[1],
                           n_bases, _threads(), out.ctypes.data_as(_u8p),
                           cap)
    return None if total < 0 else out[:total].tobytes()
