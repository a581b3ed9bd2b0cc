"""The grouped sorts K2b and K2c (grouped_sort_count_launch in
kmer_tpu_torch/csrc/grouped_count.cu), modelled in numpy step for step and
checked lane for lane, exactly (sorted int64 rows and int32 counts:
tolerance zero):

- the choice of body by shape and layout;
- the column body: Batcher's odd-even merge network (the comparator list
  the kernel's templates unroll), run on every column at once, the counts
  from the last row back, and the grid's hand-out of a column a thread;
- the warp body: the spans of 32 R rows, lane l's registers holding ranks
  [l R, (l + 1) R), the shared-memory transposes of the loads and stores
  (their swizzled chunk slots: a bijection, and no bank conflict in a
  quarter-warp), the bitonic stages by register or by shuffle to lane
  l ^ (j / R) with their directions, the run starts (the lane before's
  last row by a shuffle), the next start by a ballot, and the grid's
  hand-out of spans;
- the block body: the padded group pitch (no bank conflict in the column
  walk), the all-ascending bitonic network and the binary search of a
  run's end;
against grouped_count_ref and grouped_count_strided_ref, and against
kmer_tpu's fused_grouped_count and fused_grouped_count_sublane in
interpret mode through the repacked layout (lane for lane where kmer_tpu's
key is one word, k <= 15, table for table above).  Inputs come from
np.random.default_rng or hypothesis.  The CUDA kernel itself is held
against the plain versions in test_torch_cuda.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kmer_tpu.ops.pallas.fused_count import (fused_grouped_count,
                                             fused_grouped_count_sublane)
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, words_from_tpu_repacked,
                                       words_to_tpu_repacked)
from kmer_tpu_torch.ops.kernels import grouped_count as gk

from test_torch_grouped import _jax_table, _keys, _table

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kmer_tpu_torch", "csrc")
SOURCE = open(os.path.join(CSRC, "grouped_count.cu")).read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


COL_THREADS = _constant("COL_THREADS")
COL_WORDS = _constant("COL_WORDS")
WARP_THREADS = _constant("WARP_THREADS")
WARP_WORDS = _constant("WARP_WORDS")
WARP_ROWS = _constant("WARP_ROWS")
WARP_LANE_WORDS = _constant("WARP_LANE_WORDS")
SORT_THREADS = _constant("SORT_THREADS")
MIN_ROWS = _constant("MIN_ROWS")
SMEM_MAX = _constant("SMEM_MAX")
SENT = int(SENTINEL_KEY)


# ------------------------------------------------------------ shared pieces

def body_of(W: int, G: int, m: int, strided: bool) -> str:
    """The body sort_rows picks (K2b: strides (1, m); K2c: (G, 1))."""
    es, gs = (G, 1) if strided else (1, m)
    if gs == 1 and m <= 32 and m * W <= COL_WORDS:
        return "column"
    if es == 1 and gs == m and m >= 2 and warp_rows(m, W):
        return "warp"
    return "block"


def warp_rows(m: int, W: int) -> int:
    """The warp body's rows a lane: the power of two of WARP_LANE_WORDS /
    W or less, no more than m, at least max(2, m / 32); 0 when that passes
    WARP_ROWS or WARP_WORDS."""
    R = min(WARP_LANE_WORDS // W, m)
    R = 1 << (R.bit_length() - 1)
    R = max(R, 2, m // 32)
    return R if R <= WARP_ROWS and R * W <= WARP_WORDS else 0


def gt_rows(a, b):
    """Row a > row b over the leading axis of W words (word 0 first), as
    row_gt: no branch, elementwise over the other axes."""
    gt = np.zeros(a.shape[1:], bool)
    eq = np.ones(a.shape[1:], bool)
    for q in range(a.shape[0]):
        gt |= eq & (a[q] > b[q])
        eq &= a[q] == b[q]
    return gt


def hand_out(units: int, per_block: int, blocks_cap: int) -> np.ndarray:
    """Which worker (a thread of the column body, a warp of the warp body)
    takes each unit: the grid is min(ceil(units / per_block), blocks_cap)
    blocks of per_block workers, worker w taking units w, w + workers, ..."""
    blocks = min(-(-units // per_block), blocks_cap)
    workers = blocks * per_block
    taken = np.full(units, -1)
    for w in range(workers):
        taken[w::workers] = w
    return taken


# ------------------------------------------------------------ column body

def oe_network(n: int) -> list[tuple[int, int]]:
    """Batcher's odd-even merge sort of n = 2^p rows as the kernel's
    templates unroll it (oe_sort, oe_merge, oe_pairs)."""
    out = []

    def merge(lo, hi, r):
        step = 2 * r
        if step < hi - lo:
            merge(lo, hi, step)
            merge(lo + r, hi, step)
            out.extend((i, i + r) for i in range(lo + r, hi - r, step))
        else:
            out.append((lo, lo + r))

    def sort(lo, hi):
        if hi > lo:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid + 1, hi)
            merge(lo, hi, 1)

    sort(0, n - 1)
    return out


def column_counts(x):
    """x (W, m, cols) sorted: the counts from the last row back."""
    W, m, cols = x.shape
    c = np.zeros((m, cols), np.int32)
    nxt = np.full(cols, m)
    for i in range(m - 1, -1, -1):
        start = np.ones(cols, bool) if i == 0 else (
            x[:, i] != x[:, i - 1]).any(0)
        c[i] = np.where(start & (x[0, i] != SENT), nxt - i, 0)
        nxt = np.where(start, i, nxt)
    return c


def column_model(planes, blocks_cap=132 * 4):
    """The column body on (m, G) strided planes: element i of group g at
    i G + g, a column a thread."""
    x = np.stack(planes).astype(np.int64)          # (W, m, G)
    W, m, G = x.shape
    taken = hand_out(G, COL_THREADS, blocks_cap)
    assert (taken >= 0).all()
    x = x.copy()
    for a, b in oe_network(m):
        swap = gt_rows(x[:, a], x[:, b])
        lo, hi = x[:, a].copy(), x[:, b].copy()
        x[:, a] = np.where(swap, hi, lo)
        x[:, b] = np.where(swap, lo, hi)
    return list(x), column_counts(x)


# ------------------------------------------------------------ warp body

def chunk_slot(q, C: int):
    """The warp's shared slot of 16-byte chunk q, a lane writing C
    consecutive chunks."""
    q = np.asarray(q)
    return q ^ ((q // C) & 7) if C >= 2 else q


def warp_model(flat, m: int, blocks_cap=132 * 4):
    """The warp body on contiguous rows (W, n), n = G m: returns the
    sorted rows and counts, running the kernel's steps on every span at
    once."""
    x_all = np.stack(flat).astype(np.int64)
    W, n = x_all.shape
    R = warp_rows(m, W)
    S = 32 * R
    spans = -(-n // S)
    taken = hand_out(spans, WARP_THREADS // 32, blocks_cap)
    assert (taken >= 0).all()
    rows = np.full((W, spans * S), SENT)
    rows[:, :n] = x_all
    lane = np.arange(32)
    # load: R = 2 straight, else coalesced chunks into the swizzled slice,
    # then each lane's own chunks out
    if R == 2:
        x = rows.reshape(W, spans, 32, 2).copy()
    else:
        C = R // 2
        chunks = rows.reshape(W, spans, 16 * R, 2)
        slice_ = np.empty_like(chunks)
        for t in range(C):
            q = lane + 32 * t
            slice_[:, :, chunk_slot(q, C)] = chunks[:, :, q]
        x = np.empty((W, spans, 32, R), np.int64)
        for c in range(C):
            got = slice_[:, :, chunk_slot(lane * C + c, C)]
            x[..., 2 * c] = got[..., 0]
            x[..., 2 * c + 1] = got[..., 1]
    rank = lane[:, None] * R + np.arange(R)            # (32, R)
    kk = 2
    while kk <= m:
        up = (kk == m) | ((rank & kk) == 0)
        j = kk // 2
        while j >= R:                                   # shuffle stages
            lm = j // R
            y = x[:, :, lane ^ lm, :]
            lower = ((lane & lm) == 0)[:, None]
            take = (lower == up) == gt_rows(x, y)
            x = np.where(take, y, x)
            j //= 2
        for s in range(R.bit_length() - 2, -1, -1):     # register stages
            j = 1 << s
            if j < kk:
                for k in range(R):
                    if k & j == 0:
                        a, b = x[..., k].copy(), x[..., k + j].copy()
                        # one compare for both directions: equal rows
                        # swap to themselves
                        swap = gt_rows(a, b) == up[:, k]
                        x[..., k] = np.where(swap, b, a)
                        x[..., k + j] = np.where(swap, a, b)
        kk *= 2
    # counts: starts, then the next start in the lane's bits, else by the
    # ballot of the later lanes, else the span's end
    prev = x[:, :, np.maximum(lane - 1, 0), R - 1]      # __shfl_up_sync
    before = np.concatenate([prev[..., None], x[..., :-1]], axis=-1)
    start = ((rank & (m - 1)) == 0) | (x != before).any(0)
    has = start.any(-1)                                 # (spans, 32)
    mine = lane * R + np.argmax(start, -1)
    after = np.full(has.shape, S)
    for ln in range(31):
        later = has[:, ln + 1:]
        first = np.argmax(later, -1) + ln + 1
        after[:, ln] = np.where(later.any(-1),
                                mine[np.arange(has.shape[0]), first], S)
    c = np.zeros(start.shape, np.int32)
    for k in range(R):
        nxt = after.copy()
        for b in range(R - 1, k, -1):
            nxt = np.where(start[..., b], lane * R + b, nxt)
        c[..., k] = np.where(start[..., k] & (x[0, ..., k] != SENT),
                             nxt - (lane * R + k), 0)
    out = x.reshape(W, -1)[:, :n]
    return list(out), c.reshape(-1)[:n]


# ------------------------------------------------------------ block body

def block_model(planes, m: int, strided: bool):
    """The block body: gpb groups a block at a pitch of m + 1 rows, the
    all-ascending bitonic network by its thread index arithmetic, and a
    run start's end by a binary search."""
    x = np.stack(planes).astype(np.int64)
    W = x.shape[0]
    groups = x.transpose(0, 2, 1) if strided else x       # (W, G, m)
    G = groups.shape[1]
    gpb = MIN_ROWS // m if m < MIN_ROWS else 1
    pitch = m + 1
    assert gpb * pitch * W * 8 <= SMEM_MAX
    blocks = -(-G // gpb)
    tile = np.full((W, blocks, gpb * pitch), SENT)
    padded = np.full((W, blocks * gpb, m), SENT)
    padded[:, :G] = groups
    q, i = np.divmod(np.arange(gpb * m), m)
    tile[:, :, q * pitch + i] = padded.reshape(W, blocks, gpb * m)
    half = m // 2
    log_half = max(half.bit_length() - 1, 0)
    p = np.arange(gpb * half)
    kk = 2
    while kk <= m:
        j = kk // 2
        while j > 0:
            mirror = j == kk // 2
            qq = p >> log_half
            pp = p & (half - 1)
            off = pp & (j - 1)
            blk = (pp - off) << 1
            lo = qq * pitch + blk + off
            hi = qq * pitch + (blk + 2 * j - 1 - off if mirror
                               else blk + off + j)
            a, b = tile[:, :, lo].copy(), tile[:, :, hi].copy()
            swap = gt_rows(a, b)
            tile[:, :, lo] = np.where(swap, b, a)
            tile[:, :, hi] = np.where(swap, a, b)
            j //= 2
        kk *= 2
    rows = tile[:, :, q * pitch + i].reshape(W, blocks * gpb, m)[:, :G]
    # a live run start searches its group for the first greater row, every
    # row's search stepped at once
    pos = np.arange(m)
    before = np.concatenate([rows[:, :, :1], rows[:, :, :-1]], axis=2)
    start = (rows[0] != SENT) & ((pos == 0) | gt_rows(rows, before))
    lo_ = np.broadcast_to(pos + 1, (G, m)).copy()
    hi_ = np.full((G, m), m)
    g_idx = np.arange(G)[:, None]
    while (lo_ < hi_).any():
        act = lo_ < hi_
        mid = np.minimum((lo_ + hi_) // 2, m - 1)
        greater = gt_rows(rows[:, g_idx, mid], rows)
        hi_ = np.where(act & greater, mid, hi_)
        lo_ = np.where(act & ~greater, mid + 1, lo_)
    c = np.where(start, lo_ - pos, 0).astype(np.int32)
    if strided:
        return [w.T for w in rows], c.T
    return list(rows), c


# ------------------------------------------------------------ the kernel

def kernel_model(planes, strided: bool, blocks_cap: int = 132 * 4):
    """K2b (strided=False: planes (G, m)) or K2c (planes (m, G)) as the
    kernel computes it, by the body it picks, on a card of blocks_cap
    resident blocks."""
    planes = [np.asarray(p) for p in planes]
    W = len(planes)
    m, G = planes[0].shape if strided else planes[0].shape[::-1]
    body = body_of(W, G, m, strided)
    if body == "column":
        cols = planes if strided else [p.T for p in planes]   # m == 1
        s, c = column_model(cols, blocks_cap)
        return (s, c) if strided else ([w.T for w in s], c.T)
    if body == "warp":
        s, c = warp_model([p.reshape(-1) for p in planes], m, blocks_cap)
        return [w.reshape(G, m) for w in s], c.reshape(G, m)
    return block_model(planes, m, strided)


def _plain(planes, strided):
    ref = gk.grouped_count_strided_ref if strided else gk.grouped_count_ref
    s, c = ref([torch.from_numpy(np.ascontiguousarray(p)) for p in planes])
    return [w.numpy() for w in s], c.numpy()


def _rows(rng, shape, W, hi=3, dead=0.2):
    planes = [rng.integers(0, hi, shape).astype(np.int64) for _ in range(W)]
    planes[0][rng.random(shape) < dead] = SENT
    return planes


def _assert_same(got, want):
    (gs, gc), (ws, wc) = got, want
    assert len(gs) == len(ws)
    for g, w in zip(gs, ws):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(gc, wc)


# ------------------------------------------------------------ tests

def test_geometry_constants():
    """The body edges the kernel's constants give: the route shapes take
    the column body (K2c, m = 16) and the warp body (K2b, m = 256); every
    shape up to max_group_rows(W) has a body."""
    assert COL_THREADS % 32 == 0 and WARP_THREADS % 32 == 0
    assert body_of(1, 71680, 16, True) == "column"
    assert body_of(2, 54272, 16, True) == "column"
    assert body_of(1, 4480, 256, False) == "warp"
    assert body_of(2, 3392, 256, False) == "warp"
    assert body_of(1, 7, 1, False) == "column"
    assert body_of(1, 3, 64, True) == "block"
    for W in range(1, 5):
        for s in (False, True):
            m = 1
            while m <= gk.max_group_rows(W):
                b = body_of(W, 3, m, s)
                if b == "block":
                    gpb = MIN_ROWS // m if m < MIN_ROWS else 1
                    assert gpb * (m + 1) * W * 8 <= SMEM_MAX
                if b == "warp":
                    R = warp_rows(m, W)
                    assert R * W <= WARP_WORDS and m <= 32 * R
                m *= 2


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_column_network_sorts(n):
    """The odd-even merge network sorts every 0/1 input (the 0-1
    principle; random rows at n = 32), with 63 compare-exchanges at 16."""
    net = oe_network(n)
    assert all(a < b for a, b in net)
    assert len(net) == {1: 0, 2: 1, 4: 5, 8: 19, 16: 63, 32: 191}[n]
    if n <= 16:
        x = ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1).T
    else:
        x = np.random.default_rng(n).integers(0, 4, (n, 5000))
    x = x.copy()
    for a, b in net:
        lo, hi = np.minimum(x[a], x[b]), np.maximum(x[a], x[b])
        x[a], x[b] = lo, hi
    assert (np.diff(x, axis=0) >= 0).all()


@pytest.mark.parametrize("R", [4, 8, 16, 32])
def test_chunk_slots(R):
    """The warp's swizzled slice: a bijection on the span's chunks, and
    the 8 lanes of each quarter-warp on 8 different 16-byte bank groups,
    both for the lanes' own chunks and for the coalesced walk (keys, C =
    R / 2 chunks a lane; counts, R / 4)."""
    lane = np.arange(32)
    for C in (R // 2, R // 4):
        if C < 1:
            continue
        total = 32 * C
        slots = chunk_slot(np.arange(total), C)
        assert np.array_equal(np.sort(slots), np.arange(total))
        for c in range(C):
            for walk in (lane * C + c, lane + 32 * c):
                banks = chunk_slot(walk, C) % 8
                for quarter in banks.reshape(4, 8):
                    assert len(set(quarter.tolist())) == 8


@pytest.mark.parametrize("m", [16, 32, 64, 128])
def test_block_pitch_no_conflict(m):
    """The block body's strided-column walk: 16 neighbouring threads (one
    8-byte access a half-warp) on 16 different bank pairs at a pitch of
    m + 1 (at a pitch of m they would share one)."""
    gpb = MIN_ROWS // m
    t = np.arange(SORT_THREADS)
    i, q = np.divmod(t, gpb)
    for pitch, distinct in ((m + 1, 16), (m, 1)):
        r = q * pitch + i
        for half in r.reshape(-1, 16):
            assert len(set((half % 16).tolist())) == distinct


COLUMN_SHAPES = [(m, W) for m in (1, 2, 4, 8, 16, 32) for W in (1, 2, 3, 4)
                 if m * W <= COL_WORDS]
WARP_SHAPES = [(m, W) for m in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
               for W in (1, 2, 3, 4) if body_of(W, 3, m, False) == "warp"]


@pytest.mark.parametrize("m,W", COLUMN_SHAPES)
def test_column_body_equals_plain(m, W):
    """K2c's column body, G odd and even."""
    rng = np.random.default_rng(m * 10 + W)
    for G in (2 * COL_THREADS + 6, 77, 1):
        planes = _rows(rng, (m, G), W)
        assert body_of(W, G, m, True) == "column"
        _assert_same(kernel_model(planes, True), _plain(planes, True))


@pytest.mark.parametrize("m,W", WARP_SHAPES)
def test_warp_body_equals_plain(m, W):
    """K2b's warp body at its edges; G not a multiple of a block's spans
    (a partial last span where m < 32 R)."""
    rng = np.random.default_rng(m + W)
    S = 32 * warp_rows(m, W)
    G = (WARP_THREADS // 32 * S // m) * 3 + 1 if m < S else 5
    planes = _rows(rng, (G, m), W)
    _assert_same(kernel_model(planes, False), _plain(planes, False))


@pytest.mark.parametrize("m,W,strided", [(64, 1, True), (128, 2, True),
                                         (32, 3, True), (2048, 1, False),
                                         (512, 4, False), (1024, 2, False),
                                         (4096, 1, True)])
def test_block_body_equals_plain(m, W, strided):
    assert body_of(W, 3, m, strided) == "block"
    rng = np.random.default_rng(m + W)
    G = 3 if m >= 1024 else 37
    planes = _rows(rng, (m, G) if strided else (G, m), W)
    _assert_same(kernel_model(planes, strided), _plain(planes, strided))


@pytest.mark.parametrize("name", ["all_equal", "all_sentinel", "tie_last",
                                  "one_run_span", "m1"])
@pytest.mark.parametrize("strided", [False, True])
def test_model_edges(name, strided):
    """All-equal groups, all-sentinel groups, rows that tie in every word
    but the last, a run filling whole groups of a span, m = 1."""
    rng = np.random.default_rng(len(name))
    if name == "all_equal":
        m, planes = 16, [np.full((16, 64), 5, np.int64)] * 2
    elif name == "all_sentinel":
        m, planes = 256, [np.full((256, 9), SENT, np.int64),
                          rng.integers(0, 9, (256, 9))]
    elif name == "tie_last":
        m = 32
        planes = [np.zeros((32, 66), np.int64)] * 3 + [
            rng.integers(0, 2, (32, 66))]
    elif name == "one_run_span":
        m, planes = 8, [np.full((8, 256), 3, np.int64)]
    else:
        m, planes = 1, _rows(rng, (1, 101), 2)
    if not strided:
        planes = [np.ascontiguousarray(p.T) for p in planes]
    got = kernel_model(planes, strided)
    _assert_same(got, _plain(planes, strided))
    if name == "all_sentinel":
        assert not got[1].any()


@pytest.mark.parametrize("blocks_cap", [1, 3])
@pytest.mark.parametrize("m,strided", [(16, True), (2, True), (256, False),
                                       (8, False)])
def test_small_card_hand_out(blocks_cap, m, strided):
    """Grids of one and three blocks: each thread or warp takes many
    columns or spans in turn, every one exactly once."""
    rng = np.random.default_rng(blocks_cap + m)
    G = 3 * COL_THREADS * 2 + 10 if strided else 50
    planes = _rows(rng, (m, G) if strided else (G, m), 2)
    _assert_same(kernel_model(planes, strided, blocks_cap=blocks_cap),
                 _plain(planes, strided))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(0, 10), st.integers(1, 4),
       st.booleans(), st.integers(0, 2**32 - 1))
def test_model_any_groups(G, log_m, W, strided, seed):
    m = 1 << log_m
    if m > gk.max_group_rows(W):
        return
    planes = _rows(np.random.default_rng(seed), (m, G) if strided else (G, m),
                   W, hi=4)
    _assert_same(kernel_model(planes, strided), _plain(planes, strided))


@pytest.mark.parametrize("k,m", [(9, 128), (15, 256), (21, 256),
                                 (31, 512)])
def test_warp_model_equals_pallas(k, m):
    """K2b's body against kmer_tpu's Pallas K2b in interpret mode (64
    groups): lane for lane at k <= 15, the table above."""
    rng = np.random.default_rng(k * m)
    keys = _keys(rng, k, (64, m))
    rw = [jnp.asarray(w) for w in words_to_tpu_repacked(keys, k)]
    s, counts = fused_grouped_count(rw, interpret=True)
    (got_s,), got_c = kernel_model([keys], False)
    assert _table(k, got_s, got_c) == _jax_table(k, s, counts)
    if k <= 15:
        np.testing.assert_array_equal(
            got_s, words_from_tpu_repacked([np.asarray(w) for w in s], k))
        np.testing.assert_array_equal(got_c, np.asarray(counts))


@pytest.mark.parametrize("k,m", [(13, 8), (15, 16), (21, 16), (27, 32)])
def test_column_model_equals_pallas(k, m):
    """K2c's body against kmer_tpu's Pallas K2c in interpret mode: lane
    for lane at k <= 15, the table above."""
    rng = np.random.default_rng(k + m)
    keys = _keys(rng, k, (m, 512), distinct=12)
    rw = [jnp.asarray(w) for w in words_to_tpu_repacked(keys, k)]
    s, counts = fused_grouped_count_sublane(rw, interpret=True)
    (got_s,), got_c = kernel_model([keys], True)
    assert _table(k, got_s, got_c) == _jax_table(k, s, counts)
    if k <= 15:
        np.testing.assert_array_equal(
            got_s, words_from_tpu_repacked([np.asarray(w) for w in s], k))
        np.testing.assert_array_equal(got_c, np.asarray(counts))


def test_ab_script_imports_no_jax():
    """scripts/ab_grouped.py runs on the card's machine: torch and the
    port only."""
    path = os.path.join(os.path.dirname(CSRC), "..", "scripts",
                        "ab_grouped.py")
    text = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|kmer_tpu)\b", text,
                         re.M)
