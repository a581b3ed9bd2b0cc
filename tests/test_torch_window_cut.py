"""The contiguous window of K1 and K7 (csrc/kmer_window.cuh CutTile and
the cut bodies of csrc/fused_extract.cu and csrc/extract.cu), rehearsed
on the CPU, exactly (integer keys: tolerance zero).

The kernels do not run on the CPU, so a numpy model of their arithmetic is
held against ops/extract.window_keys (K7's plain version) and K1's plain
version: each block's tile staged word by word as the kernels stage it
(the packed words from each slot's first window, the ambiguity words in
the same layout), every key cut out of it with funnel shifts at its
window's alignment, the reverse complement as rc64 of forward cuts, the
(hi, lo) split compared before lo's flip, the ambiguity cut, and the
kernels' launch geometry (K1's tiles of 32 rows, K7's flat tiles of
`iters` outputs a thread) with every read checked to fall inside its part
of the slot.  The cases: every key width class (1 to 63 bases, 31, 32 and
63 at the edges of the pair layout), rows whose width is and is not a
multiple of 16, rows further apart than their width with noise past them,
packed and u8 rows (codes >= 4 masked, or read as their low two bits),
short rows and limits.  One case per key width is also held against
kmer_tpu's own extraction on JAX's CPU backend.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.ops.canonical import canonical_kmer_lanes as jax_canonical
from kmer_tpu.ops.extract import kmer_lanes as jax_kmer_lanes
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, keys_i64_to_u32,
                                       u32_to_pairs)
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import fused_extract as fe

U64 = np.uint64
M32 = U64(0xFFFFFFFF)
HI_BASES = 31
KS = [1, 2, 15, 16, 17, 21, 31, 32, 33, 47, 48, 55, 62, 63]
LS = [40, 77, 150, 160, 176]
# the kernels' constants: K1's rows a tile, fewest windows a thread, most
# warps a block; K7's threads a block, most keys a thread; shared bytes
ROWS, MIN_RUN, MAX_WARPS = 32, 8, 8
CUT_THREADS, MAX_ITERS, CUT_SMEM = 256, 8, 48 * 1024
# the H100's SMs and thread slots an SM
SMS, SLOTS_PER_SM = 132, 2048


def tile_cap(windows, n):
    return ((windows + n + 13) >> 4) + 3


def tile_stride(cap, amb):
    return cap * (1 + amb) | 1


def _fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the top 32 bits of (hi:lo) << s."""
    return ((hi << U64(32) | lo) << s) >> U64(32) & M32


def _rc64(x):
    """rc64: a 64-bit packed value's 32 bases reversed and complemented."""
    out = np.zeros_like(x)
    for i in range(32):
        out |= (U64(3) - (x >> U64(2 * i) & U64(3))) << U64(62 - 2 * i)
    return out


def _row_words(store, L, packed):
    """The kernels' row_word for every word of every row: (F, A) uint64
    (B, ceil(L / 16)); A the ambiguity words (01 a base whose code is
    >= 4), zero for packed rows."""
    W = (L + 15) // 16
    if packed:
        F = store[:, :W].view(np.uint32).astype(U64)
        return F, np.zeros_like(F)
    c = np.zeros((store.shape[0], 16 * W), np.uint8)
    c[:, :L] = store[:, :L]
    shifts = (2 * (15 - np.arange(16))).astype(U64)
    lanes = c.reshape(len(c), W, 16).astype(U64)
    F = ((lanes & U64(3)) << shifts).sum(axis=2, dtype=U64)
    A = ((lanes >= 4).astype(U64) << shifts).sum(axis=2, dtype=U64)
    return F, A


class Tile:
    """One block's tile (CutTile): slot s serves row b0 + s from window
    firsts[s] on; every read is checked to fall in its part."""

    def __init__(self, F, A, b0, firsts, n, amb, windows):
        self.n, self.amb = n, amb
        self.cap = cap = tile_cap(windows, n)
        self.stride = tile_stride(cap, amb)
        self.firsts = np.array(firsts, dtype=np.int64)
        W = F.shape[1]
        sm = np.full((len(firsts), self.stride), 0xDEADBEEF, dtype=U64)
        for s, wa in enumerate(firsts):
            for i in range(cap):
                j = (wa >> 4) + i
                sm[s, i] = F[b0 + s, j] if j < W else 0
                if amb:
                    sm[s, cap + i] = A[b0 + s, j] if j < W else 0
        self.sm = sm

    def cut64(self, s, part, q):
        j = q >> 4
        assert (q >= 0).all() and (j + 2 < self.cap).all()
        a, b, c = (self.sm[s, part + j + d] for d in range(3))
        sh = (2 * (q & 15)).astype(U64)
        return _fsl(b, a, sh) << U64(32) | _fsl(c, b, sh)

    def keys(self, s, o, canon):
        """CutTile::key: (hi, lo) uint64 of windows o of slots s."""
        n = self.n
        assert (self.firsts[s] <= o).all()
        q = o - 16 * (self.firsts[s] >> 4)
        x = self.cut64(s, 0, q)
        if n <= HI_BASES:
            v = x >> U64(64 - 2 * n)
            if canon:
                v = np.minimum(v, _rc64(x) & U64((1 << 2 * n) - 1))
            return v, np.zeros_like(v)
        m = 2 * (n - HI_BASES)
        h = x >> U64(2)
        lo = self.cut64(s, 0, q + HI_BASES) >> U64(64 - m)
        if canon:
            h2 = _rc64(self.cut64(s, 0, q + n - 32)) >> U64(2)
            l2 = _rc64(x) & U64((1 << m) - 1)
            take = (h2 < h) | ((h2 == h) & (l2 < lo))
            h, lo = np.where(take, h2, h), np.where(take, l2, lo)
        if m == 64:
            lo = lo ^ U64(1 << 63)
        return h, lo

    def ambiguous(self, s, o):
        n = self.n
        q = o - 16 * (self.firsts[s] >> 4)
        if n <= HI_BASES:
            return (self.cut64(s, self.cap, q) >> U64(64 - 2 * n)) != 0
        return ((self.cut64(s, self.cap, q) >> U64(2))
                | (self.cut64(s, self.cap, q + HI_BASES)
                   >> U64(64 - 2 * (n - HI_BASES)))) != 0


def k1_geometry(P_pad, seg, n, amb):
    """K1's tile: (windows a thread, tiles a row group, warps a block,
    shared bytes a block)."""
    run = max(seg, MIN_RUN)
    runs = -(-P_pad // run)
    tiles = -(-runs // MAX_WARPS)
    warps = -(-runs // tiles)
    cap = tile_cap(warps * run, n)
    return run, tiles, warps, ROWS * tile_stride(cap, amb) * 4


def k7_geometry(B, P, n, amb, iters=None):
    """K7's tile: (keys a thread, slots a block, shared bytes a block); by
    default `iters` as the host picks it on an H100."""
    total = B * P
    if iters is None:
        iters = min(MAX_ITERS, max(1, total // (SMS * SLOTS_PER_SM)))
    while True:
        t = CUT_THREADS * iters
        slots = min(B, (t + P - 2) // P + 1)
        smem = slots * tile_stride(tile_cap(min(P, t), n), amb) * 4
        if smem <= CUT_SMEM or iters == 1:
            return iters, slots, smem
        iters -= 1


def _valid_hi(lengths, limits, n, P):
    return np.minimum(np.minimum(P, lengths.astype(np.int64) - n + 1),
                      limits.astype(np.int64))


def _signed(x):
    return x.view(np.int64)


def k1_model(store, lengths, limits, n, L, *, canon, amb, packed, seg):
    """K1's keys (P_pad, B) the kernel's way (hi, lo planes)."""
    B, P = len(store), L - n + 1
    P_pad = -(-P // seg) * seg
    F, A = _row_words(store, L, packed)
    amb = amb and not packed
    run, tiles, warps, smem = k1_geometry(P_pad, seg, n, amb)
    assert smem <= CUT_SMEM
    hi = np.zeros((P_pad, B), np.int64)
    lo = np.zeros((P_pad, B), np.int64)
    seen = np.zeros((P_pad, B), np.int64)
    o_hi = _valid_hi(lengths, limits, n, P)
    groups = -(-B // ROWS)
    for blk in range(tiles * groups):
        b0 = blk % groups * ROWS
        o0 = blk // groups * warps * run
        assert o0 < P
        slots = min(ROWS, B - b0)
        tile = Tile(F, A, b0, [o0] * slots, n, amb, warps * run)
        for warp in range(warps):
            s0 = o0 + warp * run
            if s0 >= P_pad:
                continue
            o = np.arange(s0, min(s0 + run, P_pad))
            s, o = (x.reshape(-1) for x in np.meshgrid(np.arange(slots), o,
                                                        indexing="ij"))
            oc = np.minimum(o, P - 1)
            h, lw = tile.keys(s, oc, canon)
            ok = o < o_hi[b0 + s]
            if amb:
                ok &= ~tile.ambiguous(s, oc)
            hi[o, b0 + s] = np.where(ok, _signed(h), SENTINEL_KEY)
            lo[o, b0 + s] = np.where(ok, _signed(lw), SENTINEL_KEY)
            seen[o, b0 + s] += 1
    assert (seen == 1).all()
    return hi, lo


def k7_model(store, lengths, limits, n, L, *, canon, amb, packed,
             iters=None):
    """K7's keys (B, P) the kernel's way (hi, lo planes)."""
    B, P = len(store), L - n + 1
    F, A = _row_words(store, L, packed)
    amb = amb and not packed
    iters, max_slots, smem = k7_geometry(B, P, n, amb, iters)
    assert smem <= CUT_SMEM
    total, per = B * P, CUT_THREADS * iters
    hi = np.zeros(total, np.int64)
    lo = np.zeros(total, np.int64)
    seen = np.zeros(total, np.int64)
    o_hi = _valid_hi(lengths, limits, n, P)
    for blk in range(-(-total // per)):
        f0, f1 = blk * per, min(blk * per + per, total)
        b0 = f0 // P
        base = b0 * P
        l0, l1 = f0 - base, f1 - base
        slots = (l1 - 1) // P + 1
        assert slots <= max_slots
        tile = Tile(F, A, b0, [max(l0 - s * P, 0) for s in range(slots)],
                    n, amb, min(P, per))
        i = np.arange(l0, l1)
        s, o = i // P, i % P
        h, lw = tile.keys(s, o, canon)
        ok = o < o_hi[b0 + s]
        if amb:
            ok &= ~tile.ambiguous(s, o)
        hi[base + i] = np.where(ok, _signed(h), SENTINEL_KEY)
        lo[base + i] = np.where(ok, _signed(lw), SENTINEL_KEY)
        seen[base + i] += 1
    assert (seen == 1).all()
    return hi.reshape(B, P), lo.reshape(B, P)


def _batch(seed, B, L, *, amb, packed, extra):
    """Rows as the kernels read them: `store` is (B, row_stride) with
    `extra` words (packed) or codes (u8) of noise past each row's
    width, and for packed rows noise in the last word's bits past L;
    `codes` is the (B, L) u8 view the plain versions take (codes 4..7
    and 255 on u8 rows; with amb they are ambiguous, without it they read
    as their low two bits).  Poly-T rows, short lengths and limits."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if not packed:
        odd = rng.random((B, L)) < 0.03
        codes[odd] = rng.choice(np.array([4, 5, 6, 7, 255], np.uint8),
                                int(odd.sum()))
    codes[0] = 3
    codes[1, L // 2:] = 3
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[:3] = limits[:3] = L
    lengths[3] = 0
    if packed:
        W = (L + 15) // 16
        store = rng.integers(0, 1 << 32, (B, W + extra), dtype=np.uint64
                             ).astype(np.uint32)
        store[:, :W] = pack_batch_codes(codes)
        if L % 16:
            store[:, W - 1] |= rng.integers(0, 1 << (2 * (16 - L % 16)), B,
                                            dtype=np.uint64).astype(np.uint32)
        store = store.view(np.int32)
    else:
        store = rng.integers(0, 256, (B, L + extra), dtype=np.uint8)
        store[:, :L] = codes
    return store, codes, lengths, limits


def _planes(keys):
    return (tuple(k.numpy() for k in keys) if isinstance(keys, tuple)
            else (keys.numpy(),))


# (packed, mask_ambiguous, canonical, row_stride extra, K1 seg, K7 iters)
VARIANTS = {
    "packed_canon_wide": (True, False, True, 3, 2, None),
    "u8_amb_canon": (False, True, True, 0, 4, 3),
    "u8_lowbits_wide": (False, False, False, 5, 16, 8),
    "packed_plain": (True, False, False, 0, 8, 2),
}
CASES = [(k, L, v) for k in KS for L in LS if L >= k for v in VARIANTS]


@pytest.mark.parametrize("k,L,variant", CASES)
def test_cut_model_equals_plain(k, L, variant):
    """K1's and K7's keys the kernels' way, against their plain versions,
    at every window alignment, on packed rows (noise past L and past the
    row) and u8 rows (codes >= 4 masked or read as their low bits)."""
    packed, amb, canon, extra, seg, iters = VARIANTS[variant]
    B = 37
    store, codes, lengths, limits = _batch(k * 1000 + L, B, L, amb=amb,
                                           packed=packed, extra=extra)
    args = (torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(limits), k)
    kw = dict(canonical=canon, mask_ambiguous=amb)
    want7 = _planes(ek.extract_keys(*args, **kw))
    got7 = k7_model(store, lengths, limits, k, L, canon=canon, amb=amb,
                    packed=packed, iters=iters)
    for g, w in zip(got7, want7):
        np.testing.assert_array_equal(g, w)
    want1 = _planes(fe.fused_extract_count(*args, seg=seg, **kw)[0])
    got1 = k1_model(store, lengths, limits, k, L, canon=canon, amb=amb,
                    packed=packed, seg=seg)
    for g, w in zip(got1, want1):
        np.testing.assert_array_equal(g, w)
    assert (want7[0] != SENTINEL_KEY).any()


@pytest.mark.parametrize("k", KS)
def test_cut_model_equals_kmer_tpu(k):
    """K7's keys the kernels' way against kmer_tpu's extraction
    (kmer_lanes / canonical_kmer_lanes on JAX's CPU backend), u8 rows with
    ambiguous bases, canonical for every other width."""
    canon = KS.index(k) % 2 == 0
    L = 96
    rng = np.random.default_rng(300 + k)
    codes = rng.integers(0, 4, (24, L), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[0] = 3
    lengths = rng.integers(0, L + 1, 24).astype(np.int32)
    limits = rng.integers(1, L + 1, 24).astype(np.int32)
    lengths[:2] = limits[:2] = L
    fn = jax_canonical if canon else jax_kmer_lanes
    words, _ = fn(jnp.asarray(codes), jnp.asarray(lengths), k,
                  limits=jnp.asarray(limits), mask_ambiguous=True)
    words = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    hi, lo = k7_model(codes, lengths, limits, k, L, canon=canon, amb=True,
                      packed=False)
    if k <= HI_BASES:
        np.testing.assert_array_equal(keys_i64_to_u32(hi, k), words)
    else:
        want = u32_to_pairs(words, HI_BASES, k - HI_BASES)
        np.testing.assert_array_equal(hi.reshape(-1), want[0])
        np.testing.assert_array_equal(lo.reshape(-1), want[1])


@pytest.mark.parametrize("n", [1, 21, 31, 32, 55, 63])
def test_every_alignment_planted(n):
    """A planted key at each of the 16 alignments of a packed word, and
    its reverse complement, cut back exactly."""
    L = 16 * 3 + n + 16
    rng = np.random.default_rng(n)
    key = rng.integers(0, 4, n, dtype=np.uint8)
    codes = np.zeros((16, L), np.uint8)
    for a in range(16):
        codes[a] = rng.integers(0, 4, L)
        codes[a, 16 + a:16 + a + n] = key
    value = int("".join(map(str, key)), 4)
    rc = int("".join(str(3 - c) for c in key[::-1]), 4)
    lengths = limits = np.full(16, L, np.int32)
    for canon in (False, True):
        hi, lo = k7_model(pack_batch_codes(codes).view(np.int32), lengths,
                          limits, n, L, canon=canon, amb=False, packed=True)
        want = min(value, rc) if canon else value
        for a in range(16):
            if n <= HI_BASES:
                got = int(hi[a, 16 + a])
            else:
                r = 2 * (n - HI_BASES)
                low = int(lo[a, 16 + a]) & (2 ** 64 - 1)
                if r == 64:
                    low ^= 1 << 63
                got = int(hi[a, 16 + a]) << r | low
            assert got == want


@pytest.mark.parametrize("seg", [2, 4, 8, 16])
@pytest.mark.parametrize("k", [21, 55])
def test_k1_grid(k, seg):
    """K1's tiles on 8192 rows of 160 bases fit blocks of at most 256
    threads and the static shared-memory limit, with no empty tile, and
    run in one wave on an H100; the main path's batch (k = 21, seg 2) is
    768 blocks of 192 threads."""
    P = 160 - k + 1
    P_pad = -(-P // seg) * seg
    for amb in (False, True):
        run, tiles, warps, smem = k1_geometry(P_pad, seg, k, amb)
        assert warps * 32 <= ROWS * MAX_WARPS and smem <= CUT_SMEM
        assert (tiles - 1) * warps * run < P_pad <= tiles * warps * run
        blocks = tiles * 8192 // ROWS
        assert blocks <= SMS * (SLOTS_PER_SM // (warps * 32))
        if k == 21 and seg == 2:
            assert (blocks, warps * 32) == (768, 192)


@pytest.mark.parametrize("P", [1, 2, 7, 140, 10_000])
@pytest.mark.parametrize("n", [1, 21, 63])
def test_k7_tile_fits(P, n):
    """K7's tile stays under the static shared-memory limit at any row
    width, and the main path's batch launches at least as many threads as
    an H100 has thread slots."""
    for iters in (1, 2, MAX_ITERS, None):
        got, slots, smem = k7_geometry(8192, P, n, True, iters)
        assert smem <= CUT_SMEM and 1 <= got <= MAX_ITERS
    iters, _, _ = k7_geometry(8192, 140, 21, False)
    assert -(-8192 * 140 // (CUT_THREADS * iters)) * CUT_THREADS >= (
        SMS * SLOTS_PER_SM)
