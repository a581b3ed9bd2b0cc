"""Stable multi-word sort of int64 word planes, as one hand-written
Hopper kernel (csrc/sort.cu, an LSD radix sort) and its plain torch
version.

Counterpart of kmer_tpu/ops/pallas/sort.py `sort_words_pallas`: W (up to
MAX_WORDS) equal-length rows of words, sorted by their first `num_keys`
words (word 0 most significant), duplicates kept; the other words are
payload, and rows with equal keys keep their input order.  kmer_tpu
sorts W uint32 words; here a word is an int64 compared as signed, so the
sentinel SENTINEL = INT64_MAX sorts last.

`bits[q]` promises that key word q holds values in [0, 2**bits[q]) or
SENTINEL; 64 (the default) means any int64.  The kernel makes one pass
per 8-bit digit of bits + 1 bits (64 at 64), so a caller that knows its
key's width passes it: a 42-bit key word takes six passes, an unknown one
eight.  The plain version checks the promise on CPU tensors.

sort_words dispatches on where its inputs lie: CPU tensors run the
plain version and return new tensors; CUDA tensors launch the kernel,
which sorts them IN PLACE and returns them (or raises).  The launch never
waits on the device.  No row count is too small for the kernel, and an
empty input launches nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

SOURCE = "kmer_tpu_torch/csrc/sort.cu"
REPLACES = "kmer_tpu/ops/pallas/sort.py:134"
MAX_WORDS = 240                            # csrc/sort.cu MAX_PLANES
SENTINEL = torch.iinfo(torch.int64).max    # the padding word: sorts last
TILE_ROWS = 4096                           # rows a block of sort.cu takes
# calls of sort_words that launched the kernel (the plain version on CPU
# tensors does not count)
launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "sort.cu"), "kmer_sort",
                         cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sort_words_launch.restype = i
        lib.sort_words_launch.argtypes = [vp, i, i, vp, i64, vp, vp]
        lib.sort_scratch_words.restype = i64
        lib.sort_scratch_words.argtypes = [i, i64]
        lib.sort_tile_rows.restype = i
        got = (lib.sort_tile_rows(), lib.sort_max_planes())
        if got != (TILE_ROWS, MAX_WORDS):
            raise RuntimeError(f"sort.cu has (TILE, MAX_PLANES) = {got}, "
                               f"this wrapper {(TILE_ROWS, MAX_WORDS)}")
        _lib = lib
    return _lib


def _check(words, num_keys, bits):
    """(planes, num_keys, bits as a tuple of num_keys ints)."""
    words = list(words)
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"sort_words takes 1 to {MAX_WORDS} word planes, "
                         f"got {len(words)}")
    w0 = words[0]
    for w in words:
        if (w.dim() != 1 or w.dtype != torch.int64 or w.device != w0.device
                or w.shape != w0.shape or not w.is_contiguous()):
            raise ValueError("word planes must be contiguous 1-D int64 "
                             "tensors of one length on one device")
    num_keys = len(words) if num_keys is None else int(num_keys)
    if not 1 <= num_keys <= len(words):
        raise ValueError(f"num_keys={num_keys} not in 1..{len(words)}")
    bits = (64,) * num_keys if bits is None else tuple(int(b) for b in bits)
    if len(bits) != num_keys or not all(0 <= b <= 64 for b in bits):
        raise ValueError(f"bits={bits} must give 0..64 for each of the "
                         f"{num_keys} key words")
    return words, num_keys, bits


def _check_bits(words, bits) -> None:
    """Raise when a CPU key word breaks its bits promise."""
    for q, (w, b) in enumerate(zip(words, bits)):
        if b == 64 or w.device.type != "cpu":
            continue
        bad = (w < 0) if b == 63 else ((w < 0) | (w >= 1 << b))
        if bool((bad & (w != SENTINEL)).any()):
            raise ValueError(f"key word {q} holds values outside "
                             f"[0, 2**{b}) that are not the sentinel")


def sort_words_ref(words, num_keys=None, bits=None) -> list[torch.Tensor]:
    """Plain torch version: stable sorts of the key words, from the last
    to the first, each gathering every word."""
    out, num_keys, bits = _check(words, num_keys, bits)
    _check_bits(out[:num_keys], bits)
    for q in range(num_keys - 1, -1, -1):
        order = torch.sort(out[q], stable=True).indices
        out = [w[order] for w in out]
    return out


def sort_words(words, num_keys=None, bits=None) -> list[torch.Tensor]:
    """The W word planes (1-D int64, equal length) sorted stably by their
    first num_keys words (default all), word 0 most significant; in place
    on a GPU.  bits: the key words' value bits (default 64 each)."""
    words, num_keys, bits = _check(words, num_keys, bits)
    dev = words[0].device
    if dev.type == "cpu":
        return sort_words_ref(words, num_keys, bits)
    if dev.type != "cuda":
        raise ValueError(f"no sort_words on {dev}")
    n = words[0].numel()
    if n == 0:
        return words
    W = len(words)
    ptrs = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
    lib = load()
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.sort_scratch_words(W, n),
                              dtype=torch.int64, device=dev)
        rc = lib.sort_words_launch(ptrs, W, num_keys,
                                   (ctypes.c_int * num_keys)(*bits), n,
                                   scratch.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return words
