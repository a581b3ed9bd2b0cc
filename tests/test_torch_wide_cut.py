"""K7's multi-word tile body (csrc/extract.cu extract_wide_tile_kernel:
keys of more than 63 bases in W int64 words), rehearsed on the CPU,
exactly (integer keys: tolerance zero).

The kernel does not run on the CPU, so a numpy model of it is held
against K7's plain version (ops/extract.window_keys) and against
kmer_tpu's extraction on JAX's CPU backend:
- the plan (ops/kernels/extract.wide_plan, which the kernel library
  checks its own plan against when it loads): each block's tile of
  iters x CUT_THREADS flat outputs, the rows it touches staged from each
  slot's first window, each thread's (slot, window) by one division and
  then steps of CUT_THREADS outputs with one carry; every output of the
  (B, P) stream comes from exactly one block and thread, every staged
  tile fits the block's shared memory, and every cut the kernel makes
  reads staged words only;
- the keys: word j of the forward strand cut at o + 31 j, the reverse
  complement's as rc64 of the cut at o + n - 31 j - 32 (the last word at
  o), the canonical strand chosen by the first differing word, the
  others cut once at a position and with a transform chosen by the
  strand, the ambiguity span, the last word's flipped top bit at 32
  bases.
The cases: k = 64, 101, 125, 126, 130 and 160 (W = 3 to 6, last words of
2 to 64 bits), ragged B x P (one window a row up to a row wider than a
block's outputs), rows shorter than k and short limits, packed rows with
noise past the row and u8 rows with ambiguous codes, canonical or not,
and thread slots that give one output a thread and MAX_ITERS.  The CUDA
kernel is held against the plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.ops.canonical import canonical_kmer_lanes as jax_canonical
from kmer_tpu.ops.extract import kmer_lanes as jax_kmer_lanes
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.ops.encode import SENTINEL_KEY
from kmer_tpu_torch.ops.kernels import extract as ek
from test_torch_window_cut import Tile, _batch, _rc64, _row_words

U64 = np.uint64
HI = 31
KS = [64, 101, 125, 126, 130, 160]
# the H100's thread slots for the tile body (six resident blocks an SM),
# few enough slots that every block takes MAX_ITERS outputs a thread, and
# one output a thread
SLOTS = {"h100": ek.H100_THREAD_SLOTS, "few": 1000, "many": 10 ** 9}


def _lanes(B, P, plan):
    """The plan's blocks: (row b0, l0, slots, lanes) with lanes the (i,
    s, o) of each (thread, round) the kernel runs, i counted from row
    b0's first output (l0 the block's first), found as the kernel finds
    them."""
    total = B * P
    per = ek.CUT_THREADS * plan.iters
    step_rows, step_rest = divmod(ek.CUT_THREADS, P)
    for blk in range(-(-total // per)):
        f0 = blk * per
        f1 = min(f0 + per, total)
        b0 = f0 // P
        l0, l1 = f0 - b0 * P, f1 - b0 * P
        slots = (l1 - 1) // P + 1
        i = l0 + np.arange(ek.CUT_THREADS)
        s, o = i // P, i % P
        lanes = []
        while (i < l1).any():
            live = i < l1
            lanes.append((i[live], s[live], o[live]))
            i = i + ek.CUT_THREADS
            o = o + step_rest
            s = s + step_rows
            carry = o >= P
            o = np.where(carry, o - P, o)
            s = s + carry
        yield b0, l0, slots, [np.concatenate(x) for x in zip(*lanes)]


def _max_slots(B, P, plan):
    t = ek.CUT_THREADS * plan.iters
    return min(B, (t + P - 2) // P + 1)


@pytest.mark.parametrize("slots", list(SLOTS))
@pytest.mark.parametrize("B,L,k", [(8192, 160, 101), (2048, 160, 101),
                                   (8192, 160, 64), (2048, 160, 130),
                                   (37, 64, 64), (37, 65, 64),
                                   (301, 161, 101), (300, 1000, 1000),
                                   (333, 102, 100), (5, 900, 160),
                                   (517, 256, 200), (8193, 300, 126)])
@pytest.mark.parametrize("amb", [False, True])
def test_tile_plan(B, L, k, amb, slots):
    """Every output once, from the (slot, window) the kernel steps to;
    the tile's rows within the plan's slots and shared bytes; every cut
    (forward, reverse complement, ambiguity span) within its slot's
    staged words; rows too wide to stage take the row body."""
    P = L - k + 1
    plan = ek.wide_plan(B, L, k, amb, SLOTS[slots])
    assert 1 <= plan.iters <= ek.MAX_ITERS
    if not plan.tile:
        assert plan.iters == 1 and plan.smem > ek.CUT_SMEM
        assert k >= 500          # only rows far past a read take it
        return
    assert plan.smem == _max_slots(B, P, plan) * (plan.stride + 1) * 4
    assert plan.smem <= ek.CUT_SMEM
    assert plan.stride % 2 == 1 and plan.stride >= plan.cap * (1 + amb)
    W = tenc.words64(k)
    seen = np.zeros(B * P, np.int64)
    for b0, l0, slots_, (i, s, o) in _lanes(B, P, plan):
        assert slots_ <= _max_slots(B, P, plan)
        assert (s * P + o == i).all() and (0 <= o).all() and (o < P).all()
        assert (s < slots_).all() and (b0 + s < B).all()
        np.add.at(seen, b0 * P + i, 1)
        # the slot's staged words start at its first window's word; the
        # furthest word a cut reads is its position's word + 2
        first = np.maximum(l0 - s * P, 0)
        q = o - 16 * (first >> 4)
        assert (first <= o).all() and (o - first < min(P, 256 * plan.iters)
                                       ).all()
        reads = [q + HI * j for j in range(W)]                  # forward
        reads += [q + k - HI * j - 32 for j in range(W - 1)]    # reverse
        reads += [q + t for t in range(0, k, 32)]               # ambiguity
        for r in reads:
            assert (r >= 0).all() and ((r >> 4) + 2 < plan.cap).all()
    assert (seen == 1).all()


def _model(store, lengths, limits, n, L, *, canon, amb, packed, slots):
    """The tile body's W key planes (B, P) of a batch, the kernel's way."""
    B, P = len(store), L - n + 1
    W = tenc.words64(n)
    rest = n - HI * (W - 1)
    last_shift = U64(64 - 2 * rest)
    last_mask = U64((1 << 64) - 1 if rest == 32 else (1 << 2 * rest) - 1)
    last_flip = U64(1 << 63 if rest == 32 else 0)
    F, A = _row_words(store, L, packed)
    amb = amb and not packed
    plan = ek.wide_plan(B, L, n, amb, slots)
    assert plan.tile
    out = np.full((W, B * P), -1, np.int64)
    o_hi = np.minimum(lengths.astype(np.int64) - n + 1,
                      limits.astype(np.int64))
    for b0, l0, slots_, (i, s, o) in _lanes(B, P, plan):
        tile = Tile(F, A, b0, [max(l0 - x * P, 0) for x in range(slots_)],
                    n, amb, min(P, ek.CUT_THREADS * plan.iters))
        assert (tile.cap, tile.stride) == (plan.cap, plan.stride)
        q = o - 16 * (tile.firsts[s] >> 4)
        ok = o < o_hi[b0 + s]
        if amb:
            for t in range(0, n, 32):
                m = min(32, n - t)
                ok &= (tile.cut64(s, tile.cap, q + t) >> U64(64 - 2 * m)) == 0

        def fw(j):
            bj = HI if j < W - 1 else rest
            return tile.cut64(s, 0, q + HI * j) >> U64(64 - 2 * bj)

        def rcw(j):
            if j < W - 1:
                return _rc64(tile.cut64(s, 0, q + n - HI * j - 32)) >> U64(2)
            return _rc64(tile.cut64(s, 0, q)) & last_mask

        w0 = fw(0)
        rc = np.zeros(len(i), bool)
        if canon:
            r0 = rcw(0)
            rc = r0 < w0
            tie = r0 == w0
            for j in range(1, W):
                x, y = fw(j), rcw(j)
                rc = np.where(tie & (x != y), y < x, rc)
                tie &= x == y
            w0 = np.where(rc, r0, w0)
        lane = b0 * P + i
        out[0, lane] = np.where(ok, w0.view(np.int64), SENTINEL_KEY)
        at = np.where(rc, q + n - HI - 32, q + HI)
        step = np.where(rc, -HI, HI)
        for j in range(1, W):
            last = j == W - 1
            x = tile.cut64(s, 0, np.where(rc & last, q, at))
            v = x >> (last_shift if last else U64(2))
            if canon:
                r = _rc64(x)
                v = np.where(rc, r & last_mask if last else r >> U64(2), v)
            if last:
                v ^= last_flip
            out[j, lane] = np.where(ok, v.view(np.int64), SENTINEL_KEY)
            at = at + step
    return [p.reshape(B, P) for p in out]


def _plant_ties(store, codes, lengths, limits, k, L, packed):
    """Rows 2 and 4 in full: row 2 holds at window 0 a key whose first 31
    bases are the reverse complement of its last 31 (the strands tie on
    word 0, so the canonical walk goes on), row 4 a reverse-complement
    palindrome where k is even (the strands tie on every word)."""
    rng = np.random.default_rng(k + L)
    for row, whole in ((2, False), (4, k % 2 == 0)):
        key = rng.integers(0, 4, k, dtype=np.uint8)
        half = k // 2 if whole else HI
        key[k - half:] = 3 - key[:half][::-1]
        codes[row, :k] = key
        lengths[row] = limits[row] = L
        if packed:
            W = (L + 15) // 16
            store.view(np.uint32)[row, :W] = pack_batch_codes(
                codes[row:row + 1])[0]
        else:
            store[row, :L] = codes[row]


# (packed, mask_ambiguous, canonical, row_stride extra)
VARIANTS = {"packed_canon": (True, False, True, 3),
            "u8_amb_canon": (False, True, True, 0),
            "u8_lowbits": (False, False, False, 5),
            "packed_plain": (True, False, False, 0)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("k,L,slots", [(64, 64, "h100"), (64, 160, "few"),
                                       (101, 102, "h100"),
                                       (101, 160, "many"),
                                       (125, 300, "few"), (126, 160, "h100"),
                                       (130, 161, "few"), (160, 176, "h100"),
                                       (160, 450, "many")])
def test_model_equals_plain(k, L, slots, variant):
    """The tile body's keys the kernel's way against the plain version, at
    every window alignment, packed rows with noise past the row and u8
    rows (codes >= 4 masked, or read as their low two bits)."""
    packed, amb, canon, extra = VARIANTS[variant]
    B = 37
    store, codes, lengths, limits = _batch(k * 7 + L, B, L, amb=amb,
                                           packed=packed, extra=extra)
    _plant_ties(store, codes, lengths, limits, k, L, packed)
    want = ek.extract_keys_ref(torch.from_numpy(codes),
                               torch.from_numpy(lengths),
                               torch.from_numpy(limits), k, canonical=canon,
                               mask_ambiguous=amb)
    got = _model(store, lengths, limits, k, L, canon=canon, amb=amb,
                 packed=packed, slots=SLOTS[slots])
    assert len(got) == len(want) == tenc.words64(k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert (want[0] != SENTINEL_KEY).any()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canon", [False, True])
def test_model_equals_kmer_tpu(k, canon):
    """The tile body's keys against kmer_tpu's kmer_lanes and
    canonical_kmer_lanes on JAX's CPU backend, u8 rows with ambiguous
    bases under the mask, rows shorter than k and short limits."""
    L = k + 40
    rng = np.random.default_rng(500 + k)
    codes = rng.integers(0, 4, (16, L), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.005] = 4
    codes[0] = 3
    lengths = rng.integers(0, L + 1, 16).astype(np.int32)
    limits = rng.integers(1, L + 1, 16).astype(np.int32)
    lengths[:3] = limits[:3] = L
    lengths[3] = k - 1
    fn = jax_canonical if canon else jax_kmer_lanes
    words, _ = fn(jnp.asarray(codes), jnp.asarray(lengths), k,
                  limits=jnp.asarray(limits), mask_ambiguous=True)
    words = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    want = tenc.u32_to_planes(words, tenc.word_bases(k))
    got = _model(codes, lengths, limits, k, L, canon=canon, amb=True,
                 packed=False, slots=SLOTS["few"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.reshape(-1), w)
    assert (want[0] != SENTINEL_KEY).any()


def test_ab_extract_script_imports_no_jax():
    """scripts/ab_extract.py runs on the card's machine: torch, numpy and
    the port only, and builds with scripts/ab_histogram.py's `build`."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "scripts", "ab_extract.py")
    with open(path) as f:
        text = f.read()
    assert "def main" in text and "from ab_histogram import build" in text
    assert not re.search(r"^\s*(import|from)\s+(jax|kmer_tpu)\b", text,
                         re.M)
