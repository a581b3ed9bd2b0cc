"""The rolled spaced-seed window of K1 and K7 (csrc/kmer_window.cuh
SpanWalk), rehearsed on the CPU, exactly (integer keys: tolerance zero).

The kernels do not run on the CPU, so the host side of their window is checked
instead: ops/extract.seed_runs and seed_cut_table (the launch argument),
and a helper that computes every window's key the kernel's way -- span
registers rolled one base at a time from each chunk's start, the key cut
out of them piece by piece as the kernel loops over the table's groups,
the canonical min, the rolled ambiguity bits against the selection mask,
the (hi, lo) split -- held against ops/extract.window_keys, which
tests/test_torch_spaced.py holds against kmer_tpu.  The masks: chip_smoke's
two, spans of exactly 32 and 64, single-base runs, a 32-base run (lo's
flipped top bit), a non-palindromic mask, and ambiguous codes at
don't-care offsets only; a span over 64 bases (the gathered window) is
checked against kmer_tpu's string oracle.
"""

import zlib

import numpy as np
import pytest
import torch

from kmer_tpu.utils import oracle
from kmer_tpu_torch.ops import extract as text
from kmer_tpu_torch.ops.encode import PAIR_BASES, SENTINEL_KEY
from kmer_tpu_torch.ops.kernels import extract as ek

MASK24 = "1110111011101110111011101110111"
MASK42 = "1110111011101110111011101110111011101110111011101110111"
ROLLED_MASKS = [
    "1101011", "11011", "1010101", "110100101011", MASK24, MASK42,
    "1111" + "0" * 24 + "1111",          # span 32, one key word
    "1" * 32,                            # span 32, a 32-base key (pair)
    "1" * 20 + "0" * 24 + "1" * 20,      # span 64
    "1" * 31 + "0" + "1" * 32,           # span 64, lo a 32-base run
    "10" * 31 + "1",                     # 32 single-base runs
]
GATHER_MASK = "1" * 10 + "0" * 80 + "1" * 10          # span 100
M32, M64 = (1 << 32) - 1, (1 << 64) - 1


def _words(n_bases, span):
    """(span register words, key words) of the kernel's templates."""
    kw = 2 if n_bases <= 31 else 4
    return (2 if span <= 32 and kw == 2 else 4), kw


def _rotr32(x, r):
    return ((x >> r) | (x << (32 - r))) & M32


def _cut(reg, table, sw_n, kw_n):
    """kmer_window.cuh cut_key: the key cut out of a span register's words,
    group by group, only the (source word, key word) groups it visits."""
    start = table[:text.CUT_GROUPS + 1]
    pieces = table[text.CUT_GROUPS + 1:]
    key = [0] * kw_n
    for sw in range(sw_n):
        src = (reg >> (32 * sw)) & M32
        for dw in range(min(sw + 1, kw_n)):
            g = sw * text.CUT_WORDS + dw
            for i in range(start[g], start[g + 1]):
                mask, rot = pieces[2 * i], pieces[2 * i + 1]
                key[dw] |= _rotr32(src, rot) & mask
    return sum(w << (32 * j) for j, w in enumerate(key))


def _split(v, n):
    """kmer_window.cuh split_key: the int64 key, or the (hi, lo) pair with
    lo's top bit flipped at 32 lo bases (signed int64 values)."""
    def signed(x):
        return x - (1 << 64) if x >> 63 else x
    if n <= 31:
        return (v,)
    s = 2 * (n - 31)
    lo = v & ((1 << s) - 1) if s < 64 else (v & M64) ^ (1 << 63)
    return v >> s, signed(lo)


def kernel_way_keys(codes, lengths, limits, positions, *, canonical,
                    mask_ambiguous, chunk=32):
    """Every window's key word(s) as the rolled kernel computes them: a
    list of (B, P) int64 arrays (one, or hi and lo)."""
    span, n = positions[-1] + 1, len(positions)
    sw_n, kw_n = _words(n, span)
    table = text.seed_cut_table(positions)
    sel = table[-2] | table[-1] << 32
    B, L = codes.shape
    P = L - span + 1
    out = np.full((1 if n <= 31 else 2, B, P), SENTINEL_KEY, np.int64)
    for b in range(B):
        o_hi = min(P, int(lengths[b]) - span + 1, int(limits[b]))
        for o0 in range(0, P, chunk):
            fw = rc = amb = 0
            for q in range(o0, min(o0 + chunk, P) + span - 1):
                c = int(codes[b, q]) if q < L else 0
                fw = ((fw << 2) | (c & 3)) & ((1 << 32 * sw_n) - 1)
                rc = (rc >> 2) | ((3 - (c & 3)) << (2 * span - 2))
                amb = ((amb << 1) | (mask_ambiguous and c >= 4)) & M64
                o = q - (span - 1)
                if o < o0:
                    continue                     # priming
                v = _cut(fw, table, sw_n, kw_n)
                if canonical:
                    v = min(v, _cut(rc, table, sw_n, kw_n))
                if o < o_hi and not amb & sel:
                    out[:, b, o] = _split(v, n)
    return list(out)


def _batch(mask, amb, B=10, L=100):
    rng = np.random.default_rng(zlib.crc32(mask.encode()) + amb)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.02] = 4
    codes[0] = 3                                  # poly-T: lo's flipped bit
    lengths = rng.integers(len(mask), L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[:2] = limits[:2] = L
    return codes, lengths, limits


def _plain(codes, lengths, limits, positions, canonical, amb):
    keys, _ = text.window_keys(torch.from_numpy(codes),
                               torch.from_numpy(lengths), positions,
                               limits=torch.from_numpy(limits),
                               mask_ambiguous=amb, canonical=canonical)
    return [k.numpy() for k in (keys if isinstance(keys, tuple) else (keys,))]


def test_seed_runs():
    assert text.seed_runs((0, 1, 3, 5, 6)) == [(10, 2, 6), (6, 1, 4),
                                               (0, 2, 0)]
    assert text.seed_runs(tuple(range(7))) == [(0, 7, 0)]
    runs = text.seed_runs(text.parse_seed_mask(MASK42))
    assert len(runs) == 14 and {w for _, w, _ in runs} == {3}
    assert len(text.seed_runs(text.parse_seed_mask("10" * 31 + "1"))) == 32


@pytest.mark.parametrize("mask", ROLLED_MASKS)
def test_cut_table_cuts_the_runs(mask):
    """The table's pieces, cut from random registers the kernel's way,
    give the runs' key: (value >> shift) & (4**width - 1) << place."""
    positions = text.parse_seed_mask(mask)
    span, n = len(mask), len(positions)
    table = text.seed_cut_table(positions)
    assert len(table) == text.CUT_TABLE_WORDS == 17 + 2 * PAIR_BASES + 2
    assert all(0 <= w <= M32 for w in table)
    n_pieces = table[text.CUT_GROUPS]
    assert len(text.seed_runs(positions)) <= n_pieces <= n
    sw_n, kw_n = _words(n, span)
    rng = np.random.default_rng(span)
    for _ in range(20):
        value = int.from_bytes(rng.bytes(16), "little") % (1 << 2 * span)
        want = 0
        for shift, width, place in text.seed_runs(positions):
            want |= ((value >> shift) & ((1 << 2 * width) - 1)) << place
        assert _cut(value, table, sw_n, kw_n) == want
    assert table[-2] | table[-1] << 32 == int(mask, 2)   # selection mask


def test_cut_table_refuses_wide_span():
    positions = text.parse_seed_mask(GATHER_MASK)
    with pytest.raises(ValueError, match="gathers"):
        text.seed_cut_table(positions)
    offs, cut = ek.seed_args(positions, len(GATHER_MASK))
    assert cut is None and list(offs) == list(positions)
    offs, cut = ek.seed_args(text.parse_seed_mask(MASK42), len(MASK42))
    assert list(cut) == text.seed_cut_table(text.parse_seed_mask(MASK42))
    assert ek.seed_args(None, 21) == (None, None)


class _Layout:
    """A stand-in for a kernel library's cut_layout entry."""

    def __init__(self, words):
        self.words = words

    def cut_layout(self, out):
        for i, w in enumerate(self.words):
            out[i] = w


@pytest.mark.parametrize("delta", [(0, 0, 0), (1, 0, 0), (0, -2, 0),
                                   (0, 0, 64)])
def test_check_cut_layout(delta):
    """A library whose cut table layout differs from ops/extract's is
    refused when a wrapper loads it."""
    want = (text.CUT_WORDS, text.CUT_TABLE_WORDS, text.MAX_ROLLED_SPAN)
    lib = _Layout([w + d for w, d in zip(want, delta)])
    if delta == (0, 0, 0):
        ek.check_cut_layout(lib)
    else:
        with pytest.raises(RuntimeError, match="cut table layout"):
            ek.check_cut_layout(lib)


@pytest.mark.parametrize("amb", [False, True])
@pytest.mark.parametrize("mask,canonical", [
    (m, c) for m in ROLLED_MASKS for c in (False, True)
    if not c or text.seed_mask_palindromic(m)])
def test_kernel_way_equals_window_keys(mask, canonical, amb):
    positions = text.parse_seed_mask(mask)
    codes, lengths, limits = _batch(mask, amb)
    want = _plain(codes, lengths, limits, positions, canonical, amb)
    for chunk in (32, 16):
        got = kernel_way_keys(codes, lengths, limits, positions,
                              canonical=canonical, mask_ambiguous=amb,
                              chunk=chunk)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (want[0] != SENTINEL_KEY).sum() > 0


@pytest.mark.parametrize("mask", [MASK42, "1" * 31 + "0" + "1" * 32,
                                  "10" * 31 + "1"])
def test_ambiguity_at_dont_care_offsets_only(mask):
    """Ambiguous codes at every don't-care offset of window 0 (and none at
    its selected offsets) poison no window that selects none of them."""
    positions = text.parse_seed_mask(mask)
    codes, lengths, limits = _batch(mask, False, B=4, L=90)
    limits[:] = 90
    lengths[:] = 90
    dont_care = [j for j in range(len(mask)) if j not in set(positions)]
    codes[:, dont_care] = 4
    want = _plain(codes, lengths, limits, positions, False, True)
    got = kernel_way_keys(codes, lengths, limits, positions, canonical=False,
                          mask_ambiguous=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (want[0][:, 0] != SENTINEL_KEY).all()
    sel = {o for o in range(90 - len(mask) + 1)
           if any(o + p in set(dont_care) for p in positions)}
    valid = want[0] != SENTINEL_KEY
    assert all(valid[:, o].all() != (o in sel) for o in range(valid.shape[1]))


@pytest.mark.parametrize("mask,canonical,amb", [
    ("1111" + "0" * 24 + "1111", True, True),
    ("1" * 32, True, False),
    ("1" * 20 + "0" * 24 + "1" * 20, True, True),
    ("1" * 31 + "0" + "1" * 32, False, True),
    ("10" * 31 + "1", True, False),
    (GATHER_MASK, True, True), (GATHER_MASK, False, False)])
def test_new_masks_plain_match_oracle(mask, canonical, amb):
    """The plain K1 and K7 on the new masks equal kmer_tpu's string
    oracle (the span-100 mask is the gathered window's)."""
    B, L = 12, 130
    codes, lengths, limits = _batch(mask, amb, B, L)
    limits[:] = L
    positions = text.parse_seed_mask(mask)
    keys = ek.extract_keys(torch.from_numpy(codes), torch.from_numpy(lengths),
                           torch.from_numpy(limits), len(positions),
                           canonical=canonical, mask_ambiguous=amb,
                           positions=positions)
    from test_torch_spaced import _table
    valid = (keys[0] if isinstance(keys, tuple) else keys) != SENTINEL_KEY
    got = _table(len(positions), keys, valid)
    seqs = ["".join("ACGTN"[c] for c in row[:ln])
            for row, ln in zip(codes, lengths)]
    want = oracle.oracle_spaced_count(seqs, mask, canonical=canonical,
                                      skip_invalid=True)
    assert got.to_dict() == dict(want) and got.total > 0
