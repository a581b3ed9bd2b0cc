"""The fused gapped count K3 (kmer_tpu_torch/csrc/fused_gapped.cu),
rehearsed on the CPU, exactly (integer keys and counts: tolerance zero).

The kernel does not run on the CPU, so a numpy model of its arithmetic is
held against fused_gapped_count_ref (its plain version) lane for lane,
and one case per window class against kmer_tpu's Pallas K3 in interpret
mode (as test_torch_gapped.py runs it).  The model follows the kernel
step for step:

- the plan: the rows a warp's span of SPAN lanes can touch, whether their
  words (and ambiguity words) fit STAGE_WORDS, the shared bytes, and the
  grid of resident blocks walking the spans grid-stride;
- the flat lane stream g = b T_pad + t: each thread's first lane in a span
  by one division, its chunk size by the binary search over the closed
  form lanes_before, then (b, c, o) carried lane by lane inside a step and
  step by step, with a new search only past a chunk's end or a row's;
- each window cut from the staged packed words (u8 rows packed by their
  low two bits, with ambiguity words) by funnel shifts, every read checked
  to fall inside its row's staged words, and the unstaged path's reads
  from the row itself;
- the collapse over each step's seg lanes, and the store slots: counts seg
  bytes at the step's lanes, the key planes straight from registers at
  seg 2 or through the warp's out slots (each slot's 16-byte writes in
  distinct banks), every lane written exactly once.
The kernel's constants are read from the .cu source.  The CUDA kernel
itself is held against the plain version in test_torch_cuda.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops import count as C
from kmer_tpu.ops.pallas.fused_gapped import fused_gapped_count_T
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.ops.encode import SENTINEL_KEY
from kmer_tpu_torch.ops.extract import gapped_lane_count
from kmer_tpu_torch.ops.kernels import fused_gapped as fg

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kmer_tpu_torch", "csrc")
SRC = open(os.path.join(CSRC, "fused_gapped.cu")).read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, LPT = _constant("THREADS"), _constant("LPT")
STAGE_WORDS, DIRECT_SEG = _constant("STAGE_WORDS"), _constant("DIRECT_SEG")
WARPS, SPAN = THREADS // 32, 32 * LPT
U64, M32 = np.uint64, np.uint64(0xFFFFFFFF)
# the H100's SMs, and a small card that makes each warp walk many spans
CARDS = [(132, 4), (3, 1)]


# ------------------------------------------------------------------ plan

def row_stride(L):
    return (L + 15) // 16 + 2


def out_bytes(seg):
    return 32 * (seg + 2) * 8 if seg > DIRECT_SEG else 0


def warp_bytes_of(seg, staged_words):
    """A warp's shared bytes: its out slots, then its staged rows (16-byte
    aligned)."""
    return out_bytes(seg) + -(-staged_words // 4) * 16


def plan(B, L, T_pad, packed, amb, seg):
    """The kernel's plan_of: (rows_cap, staged, warp_bytes, smem)."""
    rows = (SPAN - 2 + T_pad) // T_pad + 1
    rows_cap = min(rows, B)
    words = rows_cap * row_stride(L) * (2 if amb else 1)
    staged = not packed and words <= STAGE_WORDS
    warp_bytes = warp_bytes_of(seg, words if staged else 0)
    return rows_cap, staged, warp_bytes, WARPS * warp_bytes


def blocks_of(n, sms, per_sm):
    spans = -(-n // SPAN)
    return min(-(-spans // WARPS), sms * per_sm)


def pieces_of(n, seg, blocks):
    """Each warp's even share of the stream's steps of 32 seg lanes, in
    order, cut into pieces of at most LPT / seg steps (SPAN lanes): the
    pieces' warps, first steps and step counts, all warps together."""
    steps, warps = -(-n // (32 * seg)), blocks * WARPS
    share, extra = divmod(steps, warps)
    owners, firsts, counts = [], [], []
    for gw in range(warps):
        first = gw * share + min(gw, extra)
        last = first + share + (gw < extra)
        for s0 in range(first, last, LPT // seg):
            owners.append(gw)
            firsts.append(s0)
            counts.append(min(LPT // seg, last - s0))
    return (np.array(owners, np.int64), np.array(firsts, np.int64),
            np.array(counts, np.int64))


def staged_rows(owner, g0, g_end, T_pad, B, rows_cap):
    """Each piece's staged rows (first, count): a warp stages rows_cap
    rows from a piece's first row unless the rows it staged for its piece
    before hold the piece's rows."""
    first = np.empty(len(g0), np.int64)
    count = np.empty(len(g0), np.int64)
    b0 = held = 0
    for i in range(len(g0)):
        if i == 0 or owner[i] != owner[i - 1]:
            b0 = held = 0
        bp, b_last = g0[i] // T_pad, (g_end[i] - 1) // T_pad
        if bp < b0 or b_last >= b0 + held:
            b0, held = bp, min(B - bp, rows_cap)
        first[i], count[i] = b0, held
    return first, count


def lanes_before(c, c_min, L):
    n = np.asarray(c, np.int64) - c_min
    return n * (L + 1) - n * (c_min + c - 1) // 2


def chunk_of(t, lo, hi, c_min, L):
    """The largest c in [lo, hi] with lanes_before(c) <= t, elementwise,
    by the kernel's binary search."""
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    lo, hi = np.broadcast_to(lo, t.shape).copy(), np.broadcast_to(
        hi, t.shape).copy()
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi + 1) >> 1
        ok = lanes_before(mid, c_min, L) <= t
        lo = np.where(go & ok, mid, lo)
        hi = np.where(go & ~ok, mid - 1, hi)
    return lo


# ------------------------------------------------------------------ rows

def row_words(store, L, packed):
    """kmer::row_word for every word of every row, with the two zero words
    past the row that a cut reads: (F, A) uint64 (B, row_stride(L)); A
    the ambiguity words (01 a base whose code is >= 4), zero for packed
    rows."""
    W = (L + 15) // 16
    B = store.shape[0]
    F = np.zeros((B, row_stride(L)), U64)
    A = np.zeros_like(F)
    if packed:
        F[:, :W] = store[:, :W].view(np.uint32).astype(U64)
        return F, A
    c = np.zeros((B, 16 * W), np.uint8)
    c[:, :L] = store[:, :L]
    shifts = (2 * (15 - np.arange(16))).astype(U64)
    lanes = c.reshape(B, W, 16).astype(U64)
    F[:, :W] = ((lanes & U64(3)) << shifts).sum(axis=2, dtype=U64)
    A[:, :W] = ((lanes >= 4).astype(U64) << shifts).sum(axis=2, dtype=U64)
    return F, A


def _fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the top 32 bits of (hi:lo) << s."""
    return ((hi << U64(32) | lo) << s) >> U64(32) & M32


def cut64(words, b, q, limit):
    """kmer::cut64 of row b's words at base q; every word read must lie
    below `limit` (the row's staged words)."""
    j = q >> 4
    assert (q >= 0).all() and (j + 2 < limit).all()
    a, bb, cc = (words[b, j + d] for d in range(3))
    s = (2 * (q & 15)).astype(U64)
    return _fsl(bb, a, s) << U64(32) | _fsl(cc, bb, s)


# ------------------------------------------------------------------ kernel

def k3_model(store, lengths, limits, *, l_len, r_len, c_min, c_max, seg,
             amb, packed, L, card=CARDS[0]):
    """The kernel's lanes, step for step: (hi, lo, counts) (B, T_pad)."""
    B = store.shape[0]
    T = gapped_lane_count(L, c_min, c_max)
    T_pad = -(-T // seg) * seg
    c_hi = min(c_max, L)
    n = B * T_pad
    amb = amb and not packed
    rows_cap, staged, warp_bytes, smem = plan(B, L, T_pad, packed, amb, seg)
    assert smem <= 232448 and warp_bytes % 16 == 0
    F, A = row_words(store, L, packed)
    RS = row_stride(L)
    step = 32 * seg
    blocks = blocks_of(n, *card)
    assert 1 <= blocks
    owner, s0, nsteps = pieces_of(n, seg, blocks)
    # the pieces cover every step exactly once, in order
    assert np.array_equal(np.sort(s0), s0) and nsteps.min() >= 1
    assert np.array_equal(np.concatenate(
        [np.arange(a, a + k) for a, k in zip(s0, nsteps)]),
        np.arange(-(-n // step)))

    hi_out = np.full(n, -1, np.int64)
    lo_out = np.full(n, -1, np.int64)
    cnt_out = np.full(n, -1, np.int64)
    written = np.zeros(n, np.int64)

    g0 = s0 * step
    b0 = g0 // T_pad
    g_end = np.minimum(g0 + nsteps * step, n)
    assert ((g_end - 1) // T_pad - b0 + 1 <= rows_cap).all()
    st_b0, st_n = staged_rows(owner, g0, g_end, T_pad, B, rows_cap)
    lane = np.arange(32, dtype=np.int64)
    # (span, lane) arrays: this thread's first lane
    b = np.repeat(b0[:, None], 32, axis=1)
    t = g0[:, None] + lane * seg - b * T_pad
    over = t >= T_pad
    b = np.where(over, b + t // T_pad, b)
    t = np.where(over, t % T_pad, t)
    c = np.full(t.shape, c_hi + 1, np.int64)
    o = np.zeros(t.shape, np.int64)
    inside = t < T
    c = np.where(inside, chunk_of(np.where(inside, t, 0), c_min, c_hi,
                                  c_min, L), c)
    o = np.where(inside, t - lanes_before(c, c_min, L), 0)
    hs, rs = U64(64 - 2 * l_len), U64(64 - 2 * r_len)
    reuse = 32 - max(l_len, r_len)
    for s in range(LPT // seg):
        G = g0 + s * step                   # the warp's first lane
        warp_on = s < nsteps
        assert (G[warp_on] < n).all()
        g = G[:, None] + lane * seg
        on = warp_on[:, None] & (g < n)
        assert (g[on] % seg == 0).all()
        bb = np.where(on, b, 0)
        assert (bb < B).all()
        if staged:              # every row read lies among the staged rows
            assert ((bb - st_b0[:, None] >= 0)
                    & (bb - st_b0[:, None] < st_n[:, None]))[on].all()
        ln, lm = lengths[bb], limits[bb]
        kh = np.empty(g.shape + (seg,), np.int64)
        kl = np.empty_like(kh)
        cc, oo = c.copy(), o.copy()
        k = np.zeros(t.shape, np.int64)
        for j in range(seg):
            if j > 0:
                oo = oo + 1
                nxt = oo > L - cc
                cc = np.where(nxt, cc + 1, cc)
                oo = np.where(nxt, 0, oo)
            live = cc <= c_hi
            # the step's cuts: made anew at a chunk's first lane or when
            # the last ones cannot reach this lane's windows
            fresh = (j == 0) | (oo == 0) | (k == reuse)
            qh = np.where(live, oo, 0)
            ql = np.where(live, oo + cc - r_len, 0)
            cuts = [cut64(words, bb, q, RS) for words in (F, A)
                    for q in (qh, ql)]
            if j == 0:
                xh, xl, ah, al = cuts
            else:
                xh, xl, ah, al = (np.where(fresh, new, old) for new, old in
                                  zip(cuts, (xh, xl, ah, al)))
            k = np.where(fresh, 0, k + 1)
            assert (k <= reuse).all()
            m = (2 * k).astype(U64)
            h, w = (xh << m) >> hs, (xl << m) >> rs
            bad = np.zeros(h.shape, bool)
            if amb:
                bad = (((ah << m) >> hs) | ((al << m) >> rs)) != 0
            ok = live & (oo + cc <= ln) & (oo < lm) & ~bad
            kh[..., j] = np.where(ok, h.astype(np.int64), SENTINEL_KEY)
            kl[..., j] = np.where(ok, w.astype(np.int64), SENTINEL_KEY)
        # the collapse: count on the first occurrence
        eq = ((kh[..., :, None] == kh[..., None, :])
              & (kl[..., :, None] == kl[..., None, :]))
        upper = np.triu(np.ones((seg, seg), bool), 1)
        dup = (eq & upper.T).any(axis=-1)
        cnt = np.where((kh == SENTINEL_KEY) | dup, 0,
                       1 + (eq & upper).sum(axis=-1))
        # stores: seg count bytes at the step's lanes, then the keys
        idx = g[on][:, None] + np.arange(seg)
        cnt_out[idx] = cnt[on]
        written[idx.ravel()] += 1
        if seg <= DIRECT_SEG:
            hi_out[idx], lo_out[idx] = kh[on], kl[on]
        else:
            for plane, keys in ((hi_out, kh), (lo_out, kl)):
                _through_slots(plane, keys, G, warp_on, n, seg)
        # the next step's first lane
        t = t + step
        row = t >= T_pad
        b = np.where(row, b + t // T_pad, b)
        t = np.where(row, t % T_pad, t)
        new_c = np.full(t.shape, c_hi + 1, np.int64)
        inside = t < T
        new_c = np.where(inside, chunk_of(np.where(inside, t, 0), c_min,
                                          c_hi, c_min, L), new_c)
        new_o = np.where(inside, t - lanes_before(new_c, c_min, L), 0)
        o_step = o + step
        past = ~row & (c <= c_hi) & (o_step > L - c)
        # past chunk c: the search starts at c + 1
        lo_c = np.where(past & inside, c + 1, c_min)
        srch = np.where(past & inside, chunk_of(np.where(inside, t, 0),
                                                np.minimum(lo_c, c_hi),
                                                c_hi, c_min, L), c_hi + 1)
        c_next = np.where(row, new_c, np.where(past, srch, c))
        o_next = np.where(row, new_o, np.where(
            past, np.where(inside, t - lanes_before(srch, c_min, L), o_step),
            np.where(c <= c_hi, o_step, o)))
        c, o = c_next, o_next
    assert (written == 1).all(), "every lane stored exactly once"
    shape = (B, T_pad)
    return (hi_out.reshape(shape), lo_out.reshape(shape),
            cnt_out.astype(np.int8).reshape(shape))


def _through_slots(plane, k, G, warp_on, n, seg):
    """put_plane: each thread's seg lanes into its slot of seg + 2 words,
    then the warp's pairs from lane G on, pair = 32 m + lane from slot
    pair % (seg / 2) of thread pair / (seg / 2)."""
    P = seg + 2
    slots = np.full((k.shape[0], 32, P), -7, np.int64)
    slots[:, :, :seg] = k
    for m in range(seg // 2):
        pair = 32 * m + np.arange(32)
        owner, slot = pair // (seg // 2), pair % (seg // 2)
        for half in (0, 1):
            dst = G[:, None] + 2 * pair + half
            ok = warp_on[:, None] & (dst < n)
            plane[dst[ok]] = slots[:, owner, 2 * slot + half][ok]


def _batch(seed, B, L, *, amb, short, packed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.02] = 4
    if short:
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        limits = rng.integers(1, L + 1, B).astype(np.int32)
        lengths[:min(B, 2)] = 0
        if B > 3:
            lengths[3], limits[3] = L, L
    else:
        lengths = np.full(B, L, np.int32)
        limits = np.full(B, L, np.int32)
    store = (pack_batch_codes(codes).view(np.int32) if packed else codes)
    return codes, np.ascontiguousarray(store), lengths, limits


def _compare(seed, B, L, win, seg, *, amb=False, short=True, packed=True,
             card=CARDS[0]):
    codes, store, lengths, limits = _batch(seed, B, L, amb=amb, short=short,
                                           packed=packed)
    got = k3_model(store, lengths, limits, **win, seg=seg, amb=amb,
                   packed=packed, L=L, card=card)
    want = fg.fused_gapped_count_ref(
        torch.from_numpy(store), torch.from_numpy(lengths),
        torch.from_numpy(limits), **win, mask_ambiguous=amb, seg=seg,
        packed_width=L if packed else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    return got, codes, lengths, limits


REF = dict(l_len=27, r_len=27, c_min=80, c_max=140)
ASYM = dict(l_len=13, r_len=9, c_min=30, c_max=40)
CASES = {
    # the parity shape's windows, fewer rows; each seg
    "ref_seg2": (40, 416, REF, 2, {}),
    "ref_seg4": (24, 416, REF, 4, {}),
    "ref_seg8": (24, 416, REF, 8, dict(amb=True, packed=False)),
    "ref_seg16": (24, 416, REF, 16, {}),
    # l != r, u8 rows with ambiguity, short rows and limits
    "asym_u8_amb": (64, 160, ASYM, 4, dict(amb=True, packed=False)),
    "asym_packed": (64, 160, ASYM, 16, {}),
    # c_max > L: a partial triangle, chunks of one lane at its end
    "c_max_gt_L": (50, 120, REF, 16, dict(amb=True, packed=False)),
    "c_max_gt_L_seg2": (33, 36, ASYM, 2, {}),
    # L not a multiple of 16
    "L_77": (30, 77, dict(l_len=20, r_len=11, c_min=40, c_max=70), 8, {}),
    # B T_pad no multiple of a span (512) or a block's lanes (4096): a
    # ragged flat tail, rows that span warps, rows shorter than a span
    "ragged_tail": (5, 100, dict(l_len=5, r_len=4, c_min=10, c_max=90), 2,
                    {}),
    "rows_over_spans": (5, 300, dict(l_len=31, r_len=31, c_min=62,
                                     c_max=200), 4, {}),
    "tiny_rows": (700, 12, dict(l_len=3, r_len=2, c_min=11, c_max=14), 2,
                  dict(amb=True, packed=False)),
    "one_lane_rows": (999, 90, dict(l_len=27, r_len=27, c_min=90,
                                    c_max=140), 2, {}),
    "full_rows": (20, 256, dict(l_len=31, r_len=1, c_min=32, c_max=256), 16,
                  dict(short=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_k3_model_equals_plain(name):
    B, L, win, seg, kw = CASES[name]
    got, *_ = _compare(len(name) * 97 + B, B, L, win, seg, **kw)
    assert (got[2] > 0).any()


@pytest.mark.parametrize("name", ["ragged_tail", "rows_over_spans",
                                  "ref_seg16", "tiny_rows"])
def test_k3_model_small_card(name):
    """A grid of 3 blocks: each warp walks many spans grid-stride."""
    B, L, win, seg, kw = CASES[name]
    _compare(len(name), B, L, win, seg, card=CARDS[1], **kw)


@pytest.mark.parametrize("packed,amb,seg,staged", [(True, False, 2, False),
                                                   (False, False, 4, True),
                                                   (False, True, 16, False)])
def test_k3_model_max_row(packed, amb, seg, staged):
    """Two rows of MAX_ROW bases, 770 words each: packed rows are never
    staged; u8 rows are, but not with their ambiguity words too."""
    L = fg.MAX_ROW
    T = gapped_lane_count(L, REF["c_min"], REF["c_max"])
    assert plan(2, L, -(-T // seg) * seg, packed, amb, seg)[1] == staged
    _compare(5, 2, L, REF, seg, amb=amb, packed=packed, short=False)


def test_k3_model_unstaged_many_rows():
    """Rows of one chunk near MAX_ROW bases: a piece touches many rows,
    whose words would not fit, so the cuts read the rows themselves."""
    win = dict(l_len=31, r_len=31, c_min=12240, c_max=12288)
    L = 12250
    T = gapped_lane_count(L, win["c_min"], win["c_max"])
    assert not plan(9, L, -(-T // 4) * 4, False, True, 4)[1]
    _compare(11, 9, L, win, 4, amb=True, packed=False)


def test_k3_plan_and_geometry():
    """At the parity shape packed rows need no shared memory at seg 2 and
    u8 rows stage 2 rows a piece with their ambiguity words; a row
    narrower than c_min has no lanes and the wrapper launches nothing."""
    T = gapped_lane_count(416, 80, 140)
    assert T == 18727
    assert plan(256, 416, 18728, True, False, 2) == (2, False, 0, 0)
    assert plan(512, 416, 18728, False, True, 2) == (2, True, 448, 8 * 448)
    assert plan(256, 416, 18736, False, False, 16)[2] == warp_bytes_of(16,
                                                                       56)
    # a piece of 512 lanes at T_pad 2 touches 257 rows
    assert plan(10_000, 2, 2, True, False, 2)[0] == 257
    assert blocks_of(256 * 18728, 132, 4) == 528
    assert blocks_of(1000, 132, 4) == 1
    # u8 rows at (512, 416) on 132 x 5 blocks: each warp stages its rows
    # once, though it walks 4 pieces
    n = 512 * 18728
    owner, s0, nsteps = pieces_of(n, 2, blocks_of(n, 132, 5))
    g0 = s0 * 64
    first, count = staged_rows(owner, g0, np.minimum(g0 + nsteps * 64, n),
                               18728, 512, 2)
    stagings = 1 + ((owner[1:] != owner[:-1]) | (first[1:] != first[:-1])
                    | (count[1:] != count[:-1])).sum()
    assert len(s0) == 4 * 5280 and stagings == 5280
    codes = torch.zeros((4, 20), dtype=torch.uint8)
    lens = torch.full((4,), 20, dtype=torch.int32)
    hi, lo, counts = fg.fused_gapped_count(codes, lens, lens, l_len=6,
                                           r_len=4, c_min=21, c_max=30)
    assert hi.shape == lo.shape == counts.shape == (4, 0)


@pytest.mark.parametrize("seg", [4, 8, 16])
def test_k3_out_slots_banks(seg):
    """The out slots: the 16-byte writes of each 8-thread phase fall in
    32 distinct banks, and the copy-out reads each slot pair once."""
    P = seg + 2
    for m in range(seg // 2):
        for phase in range(4):
            lanes = np.arange(8 * phase, 8 * phase + 8)
            banks = ((lanes * P + 2 * m) * 2)[:, None] % 32 + np.arange(4)
            assert len(set(banks.ravel().tolist())) == 32
    pairs = np.arange(16 * seg)
    owner, slot = pairs // (seg // 2), pairs % (seg // 2)
    assert len(set(zip(owner.tolist(), slot.tolist()))) == 16 * seg
    assert (owner < 32).all()


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb,seg", [
    (5, 5, 12, 20, 40, False, 8),     # one-word pairs, c range partly > L
    (5, 3, 10, 14, 32, True, 2),      # asymmetric windows + ambiguity
    (27, 27, 54, 60, 80, False, 16),  # the reference's windows
])
def test_k3_model_equals_pallas_k3(llen, rlen, cmin, cmax, L, amb, seg):
    B, nb = 10, llen + rlen
    codes, store, lengths, limits = _batch(llen * 100 + cmin, B, L, amb=amb,
                                           short=True, packed=not amb)
    rflat, jcounts = fused_gapped_count_T(
        jnp.asarray(codes).T, jnp.asarray(lengths), jnp.asarray(limits),
        l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax, mask_ambiguous=amb,
        seg=seg, block_lanes=128, algo="dedup", interpret=True)
    T = gapped_lane_count(L, cmin, cmax)
    T_pad = -(-T // seg) * seg
    jc = np.asarray(jcounts).reshape(T_pad, -1)[:, :B].T
    std = np.stack([np.asarray(w).reshape(T_pad, -1)[:, :B].T
                    for w in C.unpack_words(rflat, nb)], axis=-1)
    hi, lo, counts = k3_model(store, lengths, limits, l_len=llen,
                              r_len=rlen, c_min=cmin, c_max=cmax, seg=seg,
                              amb=amb, packed=not amb, L=L)
    np.testing.assert_array_equal(counts, jc.astype(np.int8))
    live = jc > 0
    assert live.any()
    np.testing.assert_array_equal(
        tenc.pairs_to_u32(hi[live], lo[live], llen, rlen), std[live])


def test_ab_script_imports_no_jax():
    """scripts/ab_gapped.py runs where only the port is installed."""
    import ast
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "scripts",
                        "ab_gapped.py")
    for node in ast.walk(ast.parse(open(path).read())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        assert not any(m.split(".")[0] in ("jax", "kmer_tpu") for m in names)
