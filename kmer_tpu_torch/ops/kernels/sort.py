"""Lexicographic multiset sort of int64 word planes, as one hand-written
Hopper kernel (csrc/sort.cu) and its plain torch version.

Counterpart of kmer_tpu/ops/pallas/sort.py `sort_words_pallas`: W
equal-length rows of words, sorted with word 0 most significant,
duplicates kept.  kmer_tpu sorts W uint32 words; here a word is an
int64 compared as signed.  Every word the port sorts is >= 0 (keys of up
to 31 bases, the halves of a gapped (hi, lo) pair, counts), so the
sentinel SENTINEL = INT64_MAX sorts last.

sort_words dispatches on where its inputs lie: CPU tensors run the
plain version and return new tensors; CUDA tensors launch the kernel,
which sorts them IN PLACE and returns them (or raises).  No row count is
too small for the kernel, and an empty input launches nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

SOURCE = "kmer_tpu_torch/csrc/sort.cu"
REPLACES = "kmer_tpu/ops/pallas/sort.py:134"
MAX_WORDS = 4
SENTINEL = torch.iinfo(torch.int64).max    # the padding word: sorts last
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
        lib.sort_words_launch.argtypes = [vp, vp, vp, vp, i, i64, vp]
        _lib = lib
    return _lib


def _check(words) -> list[torch.Tensor]:
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
    return words


def sort_words_ref(words) -> list[torch.Tensor]:
    """Plain torch version: W stable sorts, from the last word to the
    first, each gathering every word."""
    out = _check(words)
    for q in range(len(out) - 1, -1, -1):
        order = torch.sort(out[q], stable=True).indices
        out = [w[order] for w in out]
    return out


def sort_words(words) -> list[torch.Tensor]:
    """The W word planes (1-D int64, equal length) sorted
    lexicographically, word 0 most significant; in place on a GPU."""
    words = _check(words)
    dev = words[0].device
    if dev.type == "cpu":
        return sort_words_ref(words)
    if dev.type != "cuda":
        raise ValueError(f"no sort_words on {dev}")
    n = words[0].numel()
    if n == 0:
        return words
    ptrs = [w.data_ptr() for w in words] + [None] * (MAX_WORDS - len(words))
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.sort_words_launch(*ptrs, len(words), n,
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return words
