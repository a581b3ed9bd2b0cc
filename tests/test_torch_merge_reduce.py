"""The device merge's run totals and compaction
(kmer_tpu_torch/csrc/merge_reduce.cu), modelled in numpy step for step
on the CPU and checked row for row against the plain twin
(ops/kernels/merge_reduce.merge_reduce_ref), exactly (integer words and
counts: tolerance zero):

- the segmented-sum operator (a, s) + (b, t) = (a + b, b > 0 ? t : s + t)
  is associative with (0, 0) its identity, on random triples;
- random tilings of the rows, each tile's pair combined with the pairs
  of the tiles before it, give the twin's run totals and destinations;
- the kernel: each thread's ITEMS rows with their neighbour bits, the
  thread's pair, the warp scans by shuffles up and the window total by
  shuffles down, the block scan, the tile's first output row and its
  staged slots, the decoupled look-back run under random schedules over
  status words, aggregates and prefixes left by an earlier call (the
  epochs), the cut at row C and the sentinel rows past distinct; at
  W = 1, 2, 3 and 5, on runs longer than a tile and across many tiles,
  a tile of one run, all-sentinel input, distinct == C, dead lanes,
  counts past 2**40 and R not a multiple of the tile;
- the wrapper's scratch and epochs, and its geometry against the
  kernel's.
The CUDA kernel itself is held against the twin in test_torch_cuda.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from kmer_tpu_torch.ops.kernels import merge_reduce as mr
from kmer_tpu_torch.ops.kernels.sort import SENTINEL

SRC = open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kmer_tpu_torch", "csrc", "merge_reduce.cu")).read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, ITEMS = _constant("THREADS"), _constant("ITEMS")
TILE, WARPS = THREADS * ITEMS, THREADS // 32
EPOCH_BITS, MAX_PLANES = _constant("EPOCH_BITS"), _constant("MAX_PLANES")
SLOT, AGG, INCL = map(int, re.search(
    r"constexpr int SLOT = (\d+), AGG = (\d+), INCL = (\d+);", SRC).groups())
AGGREGATE, PREFIX = 1, 2
I64 = np.iinfo(np.int64).max


# ------------------------------------------------------------ the operator

def combine(x, y):
    """(runs, sum) pairs, scalars or numpy arrays: x then y."""
    (a, s), (b, t) = x, y
    return a + b, np.where(b > 0, t, s + t)


def _pair(a, s):
    return int(a), int(s)


@pytest.mark.parametrize("seed", range(4))
def test_run_combine_is_associative(seed):
    rng = np.random.default_rng(seed)
    n = 20000
    # runs of 0 often: the carry case
    x, y, z = [(rng.integers(0, 3, n), rng.integers(-2**40, 2**40, n))
               for _ in range(3)]
    left = combine(combine(x, y), z)
    right = combine(x, combine(y, z))
    np.testing.assert_array_equal(left[0], right[0])
    np.testing.assert_array_equal(left[1], right[1])
    ident = (np.zeros(n, np.int64), np.zeros(n, np.int64))
    for got in (combine(ident, x), combine(x, ident)):
        np.testing.assert_array_equal(got[0], x[0])
        np.testing.assert_array_equal(got[1], x[1])


# ------------------------------------------------------------ inputs

def sorted_rows(rng, R: int, W: int, distinct: int, dead: float = 0.2,
                big: bool = False, runs=None):
    """R rows of W int64 key planes sorted as K6 sorts them (signed,
    word 0 first), SENTINEL rows (count 0) last, counts >= 0 riding
    along.  `runs`: run lengths to use in place of random keys."""
    if runs is not None:
        ids = np.repeat(np.arange(len(runs)), runs)
    else:
        ids = np.unique(rng.integers(0, max(distinct, 1), R),
                        return_inverse=True)[1]
    n_dead = int(R * dead)
    keys = np.stack([rng.integers(-2**62, 2**62, max(ids.max() + 1, 1))
                     for _ in range(W)], 1)
    if W > 1:     # ties on word 0 that a later word breaks
        keys[::3, 0] = keys[0, 0]
    rows = keys[ids]
    rows[len(rows) - n_dead:] = I64
    hi = 2**42 if big else 300
    counts = rng.integers(0, hi, len(rows))
    counts[len(rows) - n_dead:] = 0
    order = np.lexsort(rows.T[::-1])
    rows, counts = rows[order], counts[order]
    return [torch.from_numpy(np.ascontiguousarray(rows[:, q]))
            for q in range(W)], torch.from_numpy(counts)


def _twin(words, counts, C):
    w, c, d = mr.merge_reduce_ref(words, counts, C)
    return [x.numpy() for x in w], c.numpy(), int(d)


def _run_marks(words, counts):
    """starts, ends and real rows of the sorted rows (numpy)."""
    planes = np.stack([w.numpy() for w in words])
    R = planes.shape[1]
    diff = np.ones(R + 1, bool)
    diff[1:R] = (planes[:, 1:] != planes[:, :-1]).any(0)
    real = planes[0] != I64
    return diff[:R] & real, diff[1:] & real, real


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("W", [1, 2, 3])
def test_random_tilings_give_the_twins_totals(seed, W):
    """Cut the rows into tiles of random sizes; each tile's pair, combined
    after the pairs of the tiles before it, and each row's pair inside
    its tile give every run end its destination (runs started - 1) and
    its total, as the twin places them."""
    rng = np.random.default_rng(100 * W + seed)
    R = int(rng.integers(1, 5000))
    words, counts = sorted_rows(rng, R, W, int(rng.integers(1, R + 1)),
                                dead=float(rng.random()) * 0.5)
    C = R - int(rng.integers(0, R // 2 + 1))
    flags, ends, _ = _run_marks(words, counts)
    planes = np.stack([w.numpy() for w in words])
    c = counts.numpy()
    cuts = np.unique(np.r_[0, rng.integers(0, R, int(rng.integers(0, 40))),
                           R])
    before = (0, 0)
    got_w = [np.full(C, I64) for _ in range(W)]
    got_c = np.zeros(C, np.int64)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        run = before
        agg = (0, 0)
        for r in range(lo, hi):
            step = (int(flags[r]), int(c[r]))
            run = _pair(*combine(run, step))
            agg = _pair(*combine(agg, step))
            if ends[r] and run[0] - 1 < C:
                for q in range(W):
                    got_w[q][run[0] - 1] = planes[q, r]
                got_c[run[0] - 1] = run[1]
        assert run == _pair(*combine(before, agg))
        before = run
    want_w, want_c, want_d = _twin(words, counts, C)
    assert before[0] == want_d
    for q in range(W):
        np.testing.assert_array_equal(got_w[q], want_w[q])
    np.testing.assert_array_equal(got_c, want_c)


# ------------------------------------------------------------ kernel model

def warp_inclusive_run_scan(a, s):
    """flag_scan.cuh warp_inclusive_run_scan: shuffles up by 1, 2, 4, 8,
    16; lane l takes lane l - d's pair first."""
    a, s = a.copy(), s.copy()
    lane = np.arange(32)
    d = 1
    while d < 32:
        ua, us = np.roll(a, d), np.roll(s, d)
        ca, cs = combine((ua, us), (a, s))
        a, s = np.where(lane >= d, ca, a), np.where(lane >= d, cs, s)
        d <<= 1
    return a, s


def warp_run_total_reversed(a, s):
    """flag_scan.cuh warp_run_total_reversed: shuffles down by 1, 2, 4, 8,
    16, lane l + d's pair first; lane 0's result."""
    a, s = a.copy(), s.copy()
    lane = np.arange(32)
    d = 1
    while d < 32:
        ua, us = np.roll(a, -d), np.roll(s, -d)
        ca, cs = combine((ua, us), (a, s))
        a, s = np.where(lane + d < 32, ca, a), np.where(lane + d < 32, cs, s)
        d <<= 1
    return int(a[0]), int(s[0])


def block_exclusive_run_scan(a, s):
    """flag_scan.cuh block_exclusive_run_scan over THREADS pairs: each
    thread's exclusive prefix, and the block's total."""
    inc = [warp_inclusive_run_scan(a[w * 32:(w + 1) * 32],
                                   s[w * 32:(w + 1) * 32])
           for w in range(WARPS)]
    total = (0, 0)
    ex_a, ex_s = np.zeros(THREADS, np.int64), np.zeros(THREADS, np.int64)
    for w, (ia, is_) in enumerate(inc):
        below = total
        ina = np.r_[0, ia[:-1]]
        ins = np.r_[0, is_[:-1]]
        ea, es = combine((np.int64(below[0]), np.int64(below[1])),
                         (ina, ins))
        ex_a[w * 32:(w + 1) * 32], ex_s[w * 32:(w + 1) * 32] = ea, es
        total = _pair(*combine(total, (ia[31], is_[31])))
    return ex_a, ex_s, total


def thread_bits(planes, counts, first, R):
    """One thread's (counts, flag bits, fin bits, live bits): its ITEMS
    rows and their neighbours, as neighbour_diff and the kernel mask
    them (rows past R: key SENTINEL, count 0)."""
    rows = first + np.arange(-1, ITEMS + 1)
    inside = (rows >= 0) & (rows < R)
    vals = np.full((planes.shape[0], ITEMS + 2), I64)
    vals[:, inside] = planes[:, rows[inside]]
    c = np.where(inside[1:-1], counts[np.clip(rows[1:-1], 0, R - 1)], 0)
    x = vals[:, 1:-1]
    prev = vals[:, 0] if 0 < first <= R else x[:, 0]
    nxt = vals[:, -1] if first + ITEMS < R else x[:, -1]
    diff = np.zeros(ITEMS + 1, bool)
    diff[0] = (x[:, 0] != prev).any()
    diff[1:ITEMS] = (x[:, 1:] != x[:, :-1]).any(0)
    diff[ITEMS] = (nxt != x[:, -1]).any()
    starts, ends = diff[:ITEMS].copy(), diff[1:].copy()
    if first == 0:
        starts[0] = True
    if first < R and R - first <= ITEMS:
        ends[R - 1 - first] = True
    live = x[0] != I64
    return c, starts & live, ends & live, live


def _look_back_window(scratch, pos, epoch):
    """One window of warp 0's look-back: (done, the window's pair, tiles
    consumed)."""
    mask = (1 << EPOCH_BITS) - 1
    ready, prefix, va, vs = [], [], np.zeros(32, np.int64), np.zeros(
        32, np.int64)
    for lane in range(32):
        i = pos - lane
        w = scratch.status(i) if i >= 0 else PREFIX << EPOCH_BITS | epoch
        ready.append(w & mask == epoch)
        prefix.append(ready[-1] and w >> EPOCH_BITS == PREFIX)
    dw = next((lane for lane in range(32) if not ready[lane]), 32)
    dp = next((lane for lane in range(32) if prefix[lane]), 32)
    done = dp < dw
    stop = dp + 1 if done else dw
    for lane in range(stop):
        i = pos - lane
        if i >= 0:
            va[lane], vs[lane] = scratch.value(i, INCL if prefix[lane]
                                               else AGG)
    return done, warp_run_total_reversed(va, vs), stop


class Scratch:
    """The kernel's scratch as the wrapper keeps it across calls: int64
    words in csrc/merge_reduce.cu's layout (word 0 the tile counter, tile
    t's slot of SLOT words at 1 + SLOT t: its status word, its aggregate
    at +AGG, its inclusive prefix at +INCL), each tagged with what wrote
    it.  Reading a status word where a value was written fails: a value
    left there by an earlier call could carry the epoch in its low bits."""

    def __init__(self, rng):
        self.words, self.rng = [], rng

    def ensure(self, tiles, epoch):
        """Grown as the wrapper grows it (merge_reduce_scratch_words); a
        grown scratch here holds an earlier epoch's words and garbage
        values, where the wrapper's holds zeros."""
        n = 1 + SLOT * tiles
        if len(self.words) < n:
            self.words = [("zero", 0)] * max(n, 1024)
            for t in range((len(self.words) - 1) // SLOT):
                flag = int(self.rng.integers(1, 3))
                self.words[1 + SLOT * t] = ("status", flag << EPOCH_BITS
                                            | (epoch - 1))
                for k in range(1, SLOT):
                    self.words[1 + SLOT * t + k] = (
                        "value", int(self.rng.integers(0, 1 << 40)))

    def status(self, t):
        kind, w = self.words[1 + SLOT * t]
        assert kind in ("zero", "status"), (t, kind)
        return w

    def value(self, t, at):
        (k0, runs), (k1, total) = self.words[1 + SLOT * t + at:
                                             1 + SLOT * t + at + 2]
        assert k0 == k1 == "value", (t, k0, k1)
        return runs, total

    def publish(self, t, v, flag, epoch):
        at = 1 + SLOT * t + (INCL if flag == PREFIX else AGG)
        self.words[at], self.words[at + 1] = ("value", v[0]), ("value", v[1])
        self.words[1 + SLOT * t] = ("status", flag << EPOCH_BITS | epoch)


def look_back_prefixes(aggs, rng, scratch, epoch):
    """Each tile's exclusive prefix pair by the decoupled look-back, its
    steps interleaved by `rng`: tiles take ids in order, publish their
    aggregate, then walk back a window at a time (waiting while a word is
    missing) and publish their inclusive prefix."""
    tiles = len(aggs)
    scratch.ensure(tiles, epoch)
    before = [None] * tiles
    state, taken = {}, 0          # tile -> [phase, window pos, pair]
    while any(b is None for b in before):
        moves = (["take"] if taken < tiles else []) + [
            t for t, s in state.items() if s[0] < 2]
        t = moves[int(rng.integers(len(moves)))]
        if t == "take":
            state[taken] = [0, taken - 1, (0, 0)]
            taken += 1
            continue
        s, agg = state[t], aggs[t]
        if s[0] == 0:                                # publish the aggregate
            scratch.publish(t, agg, PREFIX if t == 0 else AGGREGATE, epoch)
            if t == 0:
                before[0], s[0] = (0, 0), 2
            else:
                s[0] = 1
        else:                                        # one window
            done, v, used = _look_back_window(scratch, s[1], epoch)
            s[2] = _pair(*combine(v, s[2]))
            s[1] -= used
            if done:
                scratch.publish(t, _pair(*combine(s[2], agg)), PREFIX, epoch)
                before[t], s[0] = s[2], 2
    return before


def kernel_model(words, counts, C, rng, scratch=None, epoch=1):
    """The kernel's output (W planes, counts of C rows, distinct) with
    its tiles' steps interleaved by `rng`."""
    planes = np.stack([w.numpy() for w in words])
    cnt = counts.numpy()
    W, R = planes.shape
    tiles = -(-R // TILE)
    scratch = scratch or Scratch(rng)
    # what each tile computes before its look-back
    tile_work = []
    for t in range(tiles):
        ths = [thread_bits(planes, cnt, t * TILE + i * ITEMS, R)
               for i in range(THREADS)]
        ma, ms = np.zeros(THREADS, np.int64), np.zeros(THREADS, np.int64)
        for i, (c, flag, _, _) in enumerate(ths):
            run = (0, 0)
            for j in range(ITEMS):
                run = (run[0] + 1, int(c[j])) if flag[j] else (
                    run[0], run[1] + int(c[j]))
            ma[i], ms[i] = run
        ex_a, ex_s, agg = block_exclusive_run_scan(ma, ms)
        n_end = np.array([int(fin.sum()) for _, _, fin, _ in ths])
        slot0 = np.r_[0, np.cumsum(n_end)[:-1]]
        tile_work.append((ths, ex_a, ex_s, agg, slot0, int(n_end.sum())))

    before = look_back_prefixes([w[3] for w in tile_work], rng, scratch,
                                epoch)

    out = np.empty((W + 1, C), np.int64)
    out[:] = 12345                                   # torch.empty
    distinct = None
    for t in range(tiles):
        ths, ex_a, ex_s, agg, slot0, n_out = tile_work[t]
        b = before[t]
        if t == tiles - 1:
            distinct = _pair(*combine(b, agg))[0]
        _, flag0, _, live0 = ths[0]
        base = b[0] - int(live0[0] and not flag0[0])
        staged = np.zeros((W + 1, TILE), np.int64)
        for i, (c, flag, fin, _) in enumerate(ths):
            run = _pair(*combine(b, (ex_a[i], ex_s[i])))
            slot = int(slot0[i])
            first = t * TILE + i * ITEMS
            for j in range(ITEMS):
                run = (run[0] + 1, int(c[j])) if flag[j] else (
                    run[0], run[1] + int(c[j]))
                if fin[j]:
                    # the slot is the run's destination, less the base
                    assert base + slot == run[0] - 1
                    staged[:W, slot] = planes[:, first + j]
                    staged[W, slot] = run[1]
                    slot += 1
        for r in range(n_out):
            if base + r < C:
                out[:, base + r] = staged[:, r]
    d = min(distinct, C)
    out[:W, d:] = I64
    out[W, d:] = 0
    return list(out[:W]), out[W], distinct


CASES = {
    "random": dict(R=9000, distinct=3000),
    "run_longer_than_a_tile": dict(runs=[5, TILE + 700, 9, 3000]),
    "run_over_many_tiles": dict(runs=[1, 7 * TILE + 11, 2]),
    "tile_of_one_run": dict(runs=[TILE, TILE, 1, TILE]),
    "all_distinct": dict(R=3 * TILE + 5, distinct=1 << 60, dead=0.0),
    "all_sentinel": dict(R=2 * TILE + 3, distinct=10, dead=1.0),
    "dead_lanes": dict(R=5000, distinct=900, dead=0.6),
    "counts_past_2_40": dict(R=6000, distinct=700, big=True),
    "one_row": dict(R=1, distinct=1, dead=0.0),
    "not_a_tile_multiple": dict(R=TILE + 1, distinct=2 * TILE, dead=0.1),
}


def _case_rows(rng, name, W):
    kw = dict(CASES[name])
    runs = kw.pop("runs", None)
    if runs is not None:
        return sorted_rows(rng, sum(runs), W, 0, dead=0.0, runs=runs)
    return sorted_rows(rng, kw.pop("R"), W, kw.pop("distinct"), **kw)


@pytest.mark.parametrize("W", [1, 2, 3, 5])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_equals_twin(name, W):
    rng = np.random.default_rng(len(name) * 7 + W)
    words, counts = _case_rows(rng, name, W)
    R = counts.numel()
    real = int((words[0] != SENTINEL).sum())
    # C: the twin's smallest legal state (the distinct keys, distinct ==
    # C), and one with room
    d = int(mr.merge_reduce_ref(words, counts, R)[2])
    for C in sorted({d, (d + R) // 2}):
        got = kernel_model(words, counts, C, rng)
        want = _twin(words, counts, C)
        assert got[2] == want[2] <= real
        for q in range(W):
            np.testing.assert_array_equal(got[0][q], want[0][q])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(3))
def test_kernel_model_repeated_calls_on_one_scratch(seed):
    """Calls in turn on one scratch, each with the next epoch, their tile
    counts rising and falling: the words an earlier call left are never
    taken for this call's, and no value is ever read as a status word,
    whatever the schedule; a longer call after a shorter one also meets
    words no call wrote."""
    rng = np.random.default_rng(seed)
    scratch = Scratch(rng)
    for epoch, (R, W) in enumerate([(5 * TILE + 3, 1), (2 * TILE, 2),
                                    (9 * TILE + 100, 1), (TILE - 1, 3),
                                    (4 * TILE, 1), (9 * TILE, 2)],
                                   start=1):
        words, counts = sorted_rows(rng, R, W, R // 3)
        C = R - int(rng.integers(0, R // 3))
        got = kernel_model(words, counts, C, rng, scratch, epoch)
        want = _twin(words, counts, C)
        assert got[2] == want[2]
        for q in range(W):
            np.testing.assert_array_equal(got[0][q], want[0][q])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_look_back_any_schedule(seed):
    """Hundreds of tiles, so that windows of 32 follow each other: every
    tile's exclusive prefix is the pairs before it combined in order,
    whatever the schedule, over an earlier call's words, the next call
    shorter."""
    rng = np.random.default_rng(seed)
    tiles = int(rng.integers(100, 400))
    runs = rng.integers(0, 3, tiles) * (rng.random(tiles) < 0.3)
    aggs = [(int(a), int(x)) for a, x in zip(runs,
                                             rng.integers(0, 1 << 40, tiles))]
    scratch = Scratch(rng)
    for epoch, n in ((1, tiles), (2, tiles // 3)):
        aggs = aggs[:n]
        got = look_back_prefixes(aggs, rng, scratch, epoch)
        want, run = [], (0, 0)
        for agg in aggs:
            want.append(run)
            run = _pair(*combine(run, agg))
        assert got == want


def test_twin_cuts_runs_past_c():
    """More real runs than C rows: both keep the first C in key order and
    count them all, as the kernel drops rows past C."""
    rng = np.random.default_rng(5)
    words, counts = sorted_rows(rng, 3 * TILE, 1, 1 << 60, dead=0.0)
    C = 2 * TILE + 17
    got = kernel_model(words, counts, C, rng)
    want = _twin(words, counts, C)
    assert got[2] == want[2] == 3 * TILE
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------------------------ the wrapper

def test_scratch_epochs(monkeypatch):
    """The wrapper's scratch: one for each (device, stream), grown for a
    longer merge (zeroed), a new epoch a call, zeroed again and back to
    epoch 1 when the epochs run out."""
    monkeypatch.setattr(mr, "_scratch", {})

    class Stream:
        cuda_stream = 4321

    dev = torch.device("cpu")
    s1, e1 = mr._scratch_and_epoch(10, dev, Stream)
    words = 2 + 5 * 5000
    s2, e2 = mr._scratch_and_epoch(words, dev, Stream)
    assert (e1, e2) == (1, 1) and s2.numel() == words
    assert int(s2.abs().sum()) == 0
    s2.fill_(9)
    mr._scratch[(None, 4321)][1] = (1 << EPOCH_BITS) - 2
    s3, e3 = mr._scratch_and_epoch(100, dev, Stream)
    assert s3 is s2 and e3 == (1 << EPOCH_BITS) - 1 and int(s3[0]) == 9
    s4, e4 = mr._scratch_and_epoch(100, dev, Stream)
    assert s4 is s2 and e4 == 1 and int(s4.abs().sum()) == 0


def test_geometry():
    """The wrapper's TILE, EPOCH_BITS and MAX_PLANES are the kernel's; a
    status word holds its flag above a 32-bit epoch; the 32-bit run
    count covers MAX_ROWS; a thread's rows and the row after them fit
    one 32-bit mask."""
    assert (mr.TILE, mr.EPOCH_BITS, mr.MAX_PLANES) == (TILE, EPOCH_BITS,
                                                       MAX_PLANES)
    assert EPOCH_BITS == 32 and mr.MAX_ROWS < 1 << 31
    assert ITEMS % 2 == 0 and ITEMS + 1 <= 32


def test_dispatch_on_the_cpu_and_elsewhere():
    """CPU tensors take the twin and count no launch; a device that is
    neither the CPU nor CUDA raises."""
    rng = np.random.default_rng(1)
    words, counts = sorted_rows(rng, 500, 2, 100)
    before = mr.launches
    got = mr.merge_reduce(words, counts, 400)
    want = mr.merge_reduce_ref(words, counts, 400)
    assert mr.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2])
    with pytest.raises(ValueError, match="no merge_reduce on meta"):
        mr.merge_reduce([w.to("meta") for w in words], counts.to("meta"),
                        400)
