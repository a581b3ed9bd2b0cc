"""Streaming distinct-k-mer estimation (HyperLogLog), bit for bit the
hash and (bucket, rho) classes of kmer_tpu/ops/sketch.py.

A HyperLogLog register is a per-bucket maximum of rho, and registers
follow from the SET of occupied (bucket, rho) classes, so the device
step is a class histogram: the fused count step's keys, each hashed to
32 bits and classed as bucket * 32 + min(rho, 31), accumulated with the
key's in-segment count as its weight into one (2**(b + 5),) int64
histogram that stays on the device across batches.  The CUDA kernel
(ops/kernels/histogram) computes the class as it loads each key; the
plain version below emulates the 32-bit wrap-around arithmetic in int64,
since torch has no uint32 multiply, shift or xor: every value stays
below 2**32, products are split so none passes 2**63, and each step
masks back to 32 bits.

The hash runs over kmer_tpu's uint32 key words, most significant first
(words_per_key(k) of them: one for k <= 15, two for 16 <= k <= 31, three
or four for the (hi, lo) pairs of 32 <= k <= 63, ceil((2 k + 1) / 32)
for any k); they are cut here from the key's int64 planes in the layout
of ops/encode.word_bases, whose values concatenate to the key's 2k-bit
value.  A spaced seed's key hashes as a k-mer of its popcount.  Keys of
up to 63 bases come from the fused count step (kernel K1), wider ones
from the row-layout extraction (kernel K7), every valid window at weight
1.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import (LO_FLIP, PAIR_BASES, SENTINEL_KEY, key_planes,
                     word_bases, words_per_key)
from .kernels.extract import extract_keys
from .kernels.fused_extract import fused_extract_count
from .kernels.histogram import hll_class_histogram

_RHO_SLOTS = 32           # class = bucket * 32 + min(rho, 31)
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for 0 <= h, c < 2**32, in int64 without
    overflow: c splits into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_words(words: list[torch.Tensor]) -> torch.Tensor:
    """32-bit mix of multi-word keys (int64 tensors of uint32 words,
    most significant first): the FNV-style combine + fmix32 of
    kmer_tpu's hash_words."""
    h = torch.full_like(words[0], 0x9E3779B9)
    for w in words:
        h = _mix32((_mul32(h ^ w, 0x01000193) + 0x811C9DC5) & _M32)
    return h


def _rho32(tail: torch.Tensor, width: int) -> torch.Tensor:
    """Leading-zero run of a `width`-bit tail plus one; a zero tail
    gives width + 1 (the smear + popcount of kmer_tpu's _rho32)."""
    x = tail
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = _mul32((x + (x >> 4)) & 0x0F0F0F0F, 0x01010101) >> 24
    return width - x + 1


def key_words(keys, k: int) -> list[torch.Tensor]:
    """k-mer keys, the int64 planes of ops/encode.word_bases(k) (one
    tensor up to 31 bases, a tuple beyond) -> kmer_tpu's uint32 key words
    as int64 tensors, most significant first: word j is bits [32 (W - 1 -
    j), 32 (W - j)) of the 2k-bit value, which each plane holds a slice of
    (a 32-base plane with its top bit flipped).  The value is the OR of
    each plane's 64 bits, as unsigned, shifted to its place, which is how
    the kernel reads a plane too; so even a lane that holds no key (a
    sentinel) hashes the same in both."""
    planes, bases = key_planes(keys), word_bases(k)
    if len(planes) != len(bases):
        raise ValueError(f"{len(planes)} key planes for a {k}-base key "
                         f"({len(bases)} expected)")
    # each plane's value and the place of its lowest bit in the key value
    values, places, pos = [], [], 2 * k
    for p, b in zip(planes, bases):
        pos -= 2 * b
        values.append(p ^ LO_FLIP if b == 32 else p)
        places.append(pos)

    def bits(lo: int) -> torch.Tensor:
        """Bits [lo, lo + 32) of the key value."""
        out = torch.zeros_like(planes[0])
        for v, b, place in zip(values, bases, places):
            a, e = max(lo, place), min(lo + 32, place + 64)
            if a < e:
                out = out | (((v >> (a - place)) & ((1 << (e - a)) - 1))
                             << (a - lo))
        return out
    W = words_per_key(k)
    return [bits(32 * (W - 1 - j)) for j in range(W)]


def hll_classes(keys, k: int, b: int) -> torch.Tensor:
    """int64 class index bucket * 32 + min(rho, 31) of each key (the
    int64 planes of ops/encode.word_bases(k)): bucket = the top b hash
    bits, rho over the other 32 - b."""
    h = hash_words(key_words(keys, k))
    tail = h & ((1 << (32 - b)) - 1)
    rho = torch.clamp(_rho32(tail, 32 - b), max=_RHO_SLOTS - 1)
    return (h >> (32 - b)) * _RHO_SLOTS + rho


def hll_step(codes: torch.Tensor, lengths: torch.Tensor,
             limits: torch.Tensor, hist: torch.Tensor, *, k: int,
             canonical: bool, b: int = 10, mask_ambiguous: bool = False,
             packed_width: int = 0, seg: int = 2,
             positions=None) -> torch.Tensor:
    """One device batch of the estimator, accumulated in place into
    `hist` ((2**(b + 5),) int64 on the batch's device); returns hist.
    Up to 63 bases: the fused count step (kernel K1) and its in-segment
    counts as weights; wider keys: the row-layout extraction (kernel K7,
    W planes, sentinel lanes) at weight 1 a valid window.  Then the class
    histogram (kernel K5).  positions: a spaced seed's k window offsets
    (k its popcount)."""
    if k > PAIR_BASES:
        keys = extract_keys(codes, lengths, limits, k, canonical=canonical,
                            mask_ambiguous=mask_ambiguous,
                            packed_width=packed_width)
        counts = (keys[0] != SENTINEL_KEY).to(torch.int8)
    else:
        keys, counts = fused_extract_count(
            codes, lengths, limits, k, canonical=canonical,
            mask_ambiguous=mask_ambiguous, seg=seg,
            packed_width=packed_width, positions=positions)
    return hll_class_histogram(keys, counts, k=k, b=b, out=hist)


def registers_from_histogram(hist: np.ndarray, b: int) -> np.ndarray:
    """(2**b,) uint8 HLL registers: per-bucket highest occupied rho
    slot."""
    occ = np.asarray(hist).reshape(1 << b, _RHO_SLOTS) > 0
    top = _RHO_SLOTS - 1 - occ[:, ::-1].argmax(axis=1)
    return np.where(occ.any(axis=1), top, 0).astype(np.uint8)


def estimate_from_registers(reg: np.ndarray, b: int) -> float:
    """The 32-bit HyperLogLog estimator with the small-range (linear
    counting) and large-range corrections (Flajolet et al. 2007)."""
    m = float(1 << b)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / np.sum(np.exp2(-reg.astype(np.float64)))
    if e <= 2.5 * m:
        v = int(np.count_nonzero(reg == 0))
        if v > 0:
            e = m * np.log(m / v)
    elif e > (1 << 32) / 30.0:
        e = -(2.0 ** 32) * np.log1p(-e / 2.0 ** 32)
    return float(e)


def estimate_from_histogram(hist: np.ndarray, b: int) -> float:
    return estimate_from_registers(registers_from_histogram(hist, b), b)
