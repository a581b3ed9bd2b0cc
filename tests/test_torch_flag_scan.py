"""The index arithmetic of the two flag-scan kernels, K4
(kmer_tpu_torch/csrc/compact.cu) and K2a (the run lengths of
kmer_tpu_torch/csrc/grouped_count.cu), modelled in numpy step for step
and checked lane for lane, exactly (integer records and counts:
tolerance zero):

- K4: the tiles, each thread's ITEMS count lanes and the warp-striped
  key rounds with their owner's rank, the block scan, the decoupled
  look-back run under random schedules over status words left by an
  earlier call's epoch, the staged slots and the store order (16-byte
  pairs from the first even output row), against compact_ref and, as a
  multiset of records, against kmer_tpu's pack_groups in interpret mode
  (decoded by records_from_tpu_rows);
- K2a: the flat starts (i % m == 0 or a row that differs from the row
  before it), each thread's RL_ROWS rows and the left neighbour from
  the lane before, the next start inside the thread, across the warp,
  across the block and by the forward scan past the tile's end, against
  run_lengths_grouped_ref and kmer_tpu's run_lengths_grouped_pallas in
  interpret mode.
Inputs come from np.random.default_rng or hypothesis.  The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py.
"""

import os
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kmer_tpu.ops.pallas.fused_count import run_lengths_grouped_pallas
from kmer_tpu.ops.pallas.fused_extract import fused_extract_count_T
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, words_from_tpu_repacked,
                                       words_to_tpu_repacked)
from kmer_tpu_torch.ops.kernels import compact as ck
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.ops.kernels import grouped_count as gk

from test_torch_compact import _batch, _multiset, _tpu_records

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kmer_tpu_torch", "csrc")


def _constant(src: str, name: str) -> int:
    text = open(os.path.join(CSRC, src)).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# K4's geometry (csrc/compact.cu)
THREADS, ITEMS = _constant("compact.cu", "THREADS"), _constant("compact.cu",
                                                               "ITEMS")
TILE, WARPS = THREADS * ITEMS, THREADS // 32
EPOCH_BITS = _constant("compact.cu", "EPOCH_BITS")
LOOK = _constant("compact.cu", "LOOK")
VALUE_BITS = _constant("compact.cu", "VALUE_BITS")
AGGREGATE, PREFIX = 1, 2
# K2a's geometry (csrc/grouped_count.cu)
RL_THREADS = _constant("grouped_count.cu", "RL_THREADS")
RL_ROWS = _constant("grouped_count.cu", "RL_ROWS")
RL_TILE, RL_WARPS = RL_THREADS * RL_ROWS, RL_THREADS // 32


# ---------------------------------------------------------------- K4 model

def _word(flag: int, epoch: int, value: int) -> int:
    return flag << 62 | epoch << VALUE_BITS | value


def _look_back_window(status, pos: int, epoch: int):
    """One window of warp 0's look-back: lane i reads the status words of
    tiles pos - LOOK i - k, k < LOOK, and the words are consumed from the
    nearest, up to and including the nearest prefix (done) or else up to
    the nearest word not of this epoch.  Returns (done, the sum of the
    consumed words, how many were consumed)."""
    mask = (1 << EPOCH_BITS) - 1
    wait, prefix, words = [], [], []
    for lane in range(32):
        w = [int(status[j]) if j >= 0 else _word(PREFIX, epoch, 0)
             for j in (pos - LOOK * lane - k for k in range(LOOK))]
        valid = [(x >> VALUE_BITS) & mask == epoch for x in w]
        wait.append(min([k for k in range(LOOK) if not valid[k]],
                        default=LOOK))
        prefix.append(min([k for k in range(LOOK)
                           if valid[k] and w[k] >> 62 == PREFIX],
                          default=LOOK))
        words += w
    waits = [lane for lane in range(32) if wait[lane] < LOOK]
    prefixes = [lane for lane in range(32) if prefix[lane] < LOOK]
    dw = waits[0] * LOOK + wait[waits[0]] if waits else None
    dp = prefixes[0] * LOOK + prefix[prefixes[0]] if prefixes else None
    done = dp is not None and (dw is None or dp < dw)
    stop = dp + 1 if done else dw if dw is not None else 32 * LOOK
    return done, sum(x & ((1 << VALUE_BITS) - 1) for x in words[:stop]), stop


def k4_prefixes(aggs, rng, epoch: int = 7):
    """Each tile's exclusive prefix by the decoupled look-back, its steps
    interleaved by `rng`: tiles take ids in order, publish their
    aggregate, then walk back a window at a time (waiting while a word is
    missing) and publish their inclusive prefix.  The status words start
    as an earlier call's (epoch - 1), which must never be read."""
    tiles = len(aggs)
    status = [_word(int(rng.integers(1, 3)), epoch - 1,
                    int(rng.integers(0, 1 << 20))) for _ in range(tiles)]
    state = {}                  # tile -> [phase, window pos, sum]
    taken, out = 0, [None] * tiles
    while any(v is None for v in out):
        moves = (["take"] if taken < tiles else []) + [
            t for t, s in state.items() if s[0] < 3]
        t = moves[int(rng.integers(len(moves)))]
        if t == "take":
            state[taken] = [0, taken - 1, 0]
            taken += 1
            continue
        s = state[t]
        if s[0] == 0:                          # publish the aggregate
            status[t] = _word(PREFIX if t == 0 else AGGREGATE, epoch,
                              aggs[t])
            if t == 0:
                out[0], s[0] = 0, 3
            else:
                s[0] = 1
        else:                                  # one look-back window
            done, add, used = _look_back_window(status, s[1], epoch)
            s[2] += add
            s[1] -= used
            if done:
                status[t] = _word(PREFIX, epoch, s[2] + aggs[t])
                out[t], s[0] = s[2], 3
    return out


def _count_slot(q):
    return q + (q >> 5)


def k4_model(planes, counts, *, r_len=0, n_bases=0, seed=0):
    """compact as csrc/compact.cu computes it: (keys, counts int64, total)
    for rows [0, total), and the store log [(thread, first row, rows)]."""
    mode = ck._mode(planes, r_len, n_bases)
    n = counts.size
    tiles = -(-n // TILE)
    c = np.zeros(tiles * TILE, np.int64)
    c[:n] = counts.reshape(-1)
    k = [np.zeros(tiles * TILE, np.int64) for _ in planes]
    for q, p in zip(k, planes):
        q[:n] = p.reshape(-1)
    aggs, tile_data = [], []
    for t in range(tiles):
        ct = c[t * TILE:(t + 1) * TILE].reshape(WARPS, 32, ITEMS)
        live = ct > 0                          # thread (w, l) owns lanes
        mine = live.sum(-1)                    # 512 w + 16 l + j
        in_warp = np.cumsum(mine, 1) - mine
        warp_tot = mine.sum(1)
        below = (np.cumsum(warp_tot) - warp_tot)[:, None] + in_warp
        aggs.append(int(mine.sum()))
        tile_data.append((ct, live, in_warp, below))
    base = k4_prefixes(aggs, np.random.default_rng(seed))
    out_k = np.zeros((n, 2) if mode == 2 else n, np.int64)
    out_c = np.zeros(n, np.int64)
    stores = []
    s = 2 * r_len
    for t, (ct, live, in_warp, below) in enumerate(tile_data):
        agg = aggs[t]
        skey = np.zeros((TILE, 2), np.uint64)
        scount = np.zeros(TILE + TILE // 32, np.int64)
        for w in range(WARPS):
            wbase = below[w, 0]
            q = below[w]                       # owners stage their counts
            for j in range(ITEMS):
                on = live[w, :, j]
                scount[_count_slot(q[on])] = ct[w, on, j]
                q = q + on
            for j in range(ITEMS):             # loaders stage their keys
                lane = np.arange(32)
                owner, bit = 2 * j + (lane >> 4), lane & 15
                on = live[w, owner, bit]
                rank = in_warp[w, owner] + np.array(
                    [live[w, o, :b].sum() for o, b in zip(owner, bit)])
                r = wbase + rank[on]
                i = t * TILE + w * 32 * ITEMS + 32 * j + lane[on]
                hi = k[0][i].astype(np.uint64)
                if mode == 0:
                    skey[r, 0] = hi
                    continue
                lo = k[1][i].astype(np.uint64)
                if mode == 1:
                    skey[r, 0] = (hi << np.uint64(s)) | lo
                elif s == 64:
                    skey[r, 0], skey[r, 1] = hi, lo ^ np.uint64(1 << 63)
                else:
                    skey[r, 0] = hi >> np.uint64(64 - s)
                    skey[r, 1] = (hi << np.uint64(s)) | lo
        b = base[t]
        rows = np.arange(agg)
        if mode == 2:
            for r in rows:
                stores.append((r % THREADS, b + r, 1))
            out_k[b:b + agg] = skey[:agg].view(np.int64)
        else:
            odd = b & 1
            for p in range(-(-(agg + odd) // 2)):
                r = 2 * p - odd
                if r >= 0 and r + 1 < agg:
                    stores.append((p % THREADS, b + r, 2))
                else:
                    r1 = r if r >= 0 else r + 1
                    if r1 < agg:
                        stores.append((p % THREADS, b + r1, 1))
            out_k[b:b + agg] = skey[:agg, 0].view(np.int64)
        out_c[b:b + agg] = scount[_count_slot(rows)]
    total = base[-1] + aggs[-1] if tiles else 0
    return out_k, out_c, total, stores


HALF_LIVE = {"n(T-1)_half": TILE - 1, "nT_half": TILE,
             "n(T+1)_half": TILE + 1, "n(3*T+17)_half": 3 * TILE + 17}


def _k4_case(name):
    """(planes, counts, kw) of a named K4 edge case: numpy arrays."""
    g = np.random.default_rng(zlib.crc32(name.encode()))

    def lanes(n, share, dtype=np.int8):
        c = ((g.random(n) < share) * g.integers(1, 100, n)).astype(dtype)
        return [g.integers(0, 1 << 62, n)], c

    if name == "n1_live":
        return [np.array([5])], np.array([3], np.int8), {}
    if name == "n1_dead":
        return [np.array([5])], np.array([0], np.int8), {}
    if name in HALF_LIVE:
        return (*lanes(HALF_LIVE[name], 0.5), {})
    if name == "all_live_6_tiles":
        return (*lanes(6 * TILE, 1.0), {})
    if name == "all_live_6_tiles_i32":
        return (*lanes(6 * TILE, 1.0, np.int32), {})
    if name == "one_live_last_tile":
        p, c = lanes(4 * TILE + 37, 0.0)
        c[-5] = 2
        return p, c, {}
    if name == "every_other_tile":
        p, c = lanes(7 * TILE, 0.7)
        c.reshape(7, TILE)[1::2] = 0
        return p, c, {}
    if name == "i32_tail_12345":
        return (*lanes(12345, 0.6, np.int32), {})
    hi = g.integers(0, 1 << 62, 2 * TILE + 3)
    lo = g.integers(-(1 << 63), 1 << 63, 2 * TILE + 3, dtype=np.int64)
    _, c = lanes(2 * TILE + 3, 0.8)
    if name == "mode1_r15":
        return ([hi & ((1 << 20) - 1), lo & ((1 << 30) - 1)], c,
                dict(r_len=15, n_bases=25))
    if name == "mode2_r24":
        return [hi, lo & ((1 << 48) - 1)], c, dict(r_len=24, n_bases=55)
    if name == "mode2_r32":
        return [hi, lo], c, dict(r_len=32, n_bases=63)
    raise KeyError(name)


K4_CASES = ["n1_live", "n1_dead", "n(T-1)_half", "nT_half", "n(T+1)_half",
            "n(3*T+17)_half", "all_live_6_tiles", "all_live_6_tiles_i32",
            "one_live_last_tile", "every_other_tile", "i32_tail_12345",
            "mode1_r15", "mode2_r24", "mode2_r32"]


def _ref(planes, counts, kw):
    keys, cts, total = ck.compact_ref([torch.from_numpy(p) for p in planes],
                                      torch.from_numpy(counts), **kw)
    t = int(total[0])
    return keys[:t].numpy(), cts[:t].numpy(), t


@pytest.mark.parametrize("name", K4_CASES)
def test_k4_model_equals_plain(name):
    planes, counts, kw = _k4_case(name)
    want_k, want_c, t = _ref(planes, counts, kw)
    for seed in range(2):                      # two look-back schedules
        got_k, got_c, total, _ = k4_model(planes, counts, seed=seed, **kw)
        assert total == t
        np.testing.assert_array_equal(got_k[:t], want_k)
        np.testing.assert_array_equal(got_c[:t], want_c)


@pytest.mark.parametrize("name", ["n(3*T+17)_half", "every_other_tile",
                                  "mode2_r24", "n1_live"])
def test_k4_store_order(name):
    """Every output row is stored once; a 16-byte store starts at an even
    row; in each pass consecutive threads store consecutive rows."""
    planes, counts, kw = _k4_case(name)
    *_, total, stores = k4_model(planes, counts, **kw)
    written = np.zeros(total, np.int64)
    for th, row, k in stores:
        written[row:row + k] += 1
        if k == 2:
            assert row % 2 == 0
    assert (written == 1).all()
    firsts = [row for _, row, _ in stores]
    assert firsts == sorted(firsts)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, TILE), min_size=1, max_size=300),
       st.integers(0, 2**32 - 1))
def test_k4_look_back_any_schedule(aggs, seed):
    """The look-back's exclusive prefixes equal a cumulative sum under any
    interleaving, past stale words of an earlier epoch."""
    got = k4_prefixes(aggs, np.random.default_rng(seed))
    assert got == list(np.cumsum(aggs) - np.array(aggs))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 3 * TILE), st.floats(0, 1), st.sampled_from([np.int8,
                                                                   np.int32]),
       st.integers(0, 2**32 - 1))
def test_k4_model_any_stream(n, share, dtype, seed):
    g = np.random.default_rng(seed)
    counts = ((g.random(n) < share) * g.integers(1, 100, n)).astype(dtype)
    planes = [g.integers(0, 1 << 62, n)]
    want_k, want_c, t = _ref(planes, counts, {})
    got_k, got_c, total, _ = k4_model(planes, counts, seed=seed)
    assert total == t
    np.testing.assert_array_equal(got_k[:t], want_k)
    np.testing.assert_array_equal(got_c[:t], want_c)


@pytest.mark.parametrize("k,canon,case", [(21, True, "random"),
                                          (31, False, "random"),
                                          (21, True, "full"),
                                          (15, False, "empty")])
def test_k4_model_equals_pallas_pack(k, canon, case):
    """The model's records from K1's stream equal, as a multiset, the rows
    kmer_tpu's pack_groups packs (interpret mode) from the same stream."""
    B, L = 48, 62
    codes, lengths, limits = _batch(k + canon, B, L, empty=case == "empty",
                                    full=case == "full")
    rflat, jcounts = fused_extract_count_T(
        jnp.asarray(codes).T, jnp.asarray(lengths), jnp.asarray(limits), k,
        canonical=canon, seg=2, block_lanes=128, algo="dedup",
        interpret=True)
    want = _tpu_records(rflat, jcounts, k)
    keys, counts = fe.fused_extract_count(
        *map(torch.from_numpy, (codes, lengths, limits)), k, canonical=canon,
        seg=2)
    got_k, got_c, total, _ = k4_model([keys.numpy()], counts.numpy())
    np.testing.assert_array_equal(_multiset(got_k[:total], got_c[:total]),
                                  _multiset(*want))


def test_k4_scratch_epochs(monkeypatch):
    """The wrapper's scratch: one for each (device, stream), grown for a
    longer stream (zeroed), a new epoch a call, zeroed again and back to
    epoch 1 when the epochs run out."""
    monkeypatch.setattr(ck, "_scratch", {})

    class Stream:
        cuda_stream = 1234

    dev = torch.device("cpu")
    s1, e1 = ck._scratch_and_epoch(10, dev, Stream)
    s2, e2 = ck._scratch_and_epoch(TILE * 5000, dev, Stream)
    assert (e1, e2) == (1, 1) and s2.numel() == 1 + 5000
    assert int(s2.abs().sum()) == 0
    s2.fill_(9)
    ck._scratch[(None, 1234)][1] = (1 << EPOCH_BITS) - 2
    s3, e3 = ck._scratch_and_epoch(TILE, dev, Stream)
    assert s3 is s2 and e3 == (1 << EPOCH_BITS) - 1 and int(s3[0]) == 9
    s4, e4 = ck._scratch_and_epoch(TILE, dev, Stream)
    assert s4 is s2 and e4 == 1 and int(s4.abs().sum()) == 0


def test_k4_geometry():
    """The wrapper's TILE and EPOCH_BITS are the kernel's; a status word's
    fields fill 64 bits; a warp's round covers the lanes of 16 owners."""
    assert (ck.TILE, ck.EPOCH_BITS) == (TILE, EPOCH_BITS)
    assert 2 + EPOCH_BITS + VALUE_BITS == 64 and ITEMS == 16


# ---------------------------------------------------------------- K2a model

def _is_start(flat, i, n, m):
    """Start flags of rows i (rows at or past n count as starts)."""
    start = (i >= n) | (i % m == 0)
    j = np.minimum(i, n - 1)
    for f in flat:
        start |= (i < n) & (f[j] != f[j - 1])
    return start


def _forward_start(flat, e, n, m):
    """The first start at or after row e: the block's last warp tests rows
    [e, e + 32); when none starts a run, the whole block scans on from
    e + 32, RL_TILE rows a step.  Returns (row, block steps)."""
    start = _is_start(flat, e + np.arange(32), n, m)
    if start.any():
        return min(e + int(np.argmax(start)), n), 0
    e, steps = e + 32, 0
    while e < n:
        steps += 1
        start = _is_start(flat, e + np.arange(RL_TILE), n, m)
        if start.any():
            return min(e + int(np.argmax(start)), n), steps
        e += RL_TILE
    return n, steps


def k2a_model(planes, paths=None):
    """run_lengths_grouped as csrc/grouped_count.cu computes it: counts
    (G, m) int32.  paths, if given, counts how each start found its next
    start: 'thread', 'warp', 'block' or 'forward' (and 'end')."""
    G, m = planes[0].shape
    n = G * m
    flat = [p.reshape(-1) for p in planes]
    counts = np.zeros(n, np.int32)
    tid = np.arange(RL_THREADS)
    lane, warp = tid % 32, tid // 32
    for t0 in range(0, n, RL_TILE):
        first = t0 + RL_ROWS * tid
        idx = first[:, None] + np.arange(RL_ROWS)
        valid = idx < n
        r = [np.where(valid, f[np.minimum(idx, n - 1)], 0) for f in flat]
        start = (first % m)[:, None] + np.arange(RL_ROWS)
        start = start % m == 0
        for f, q in zip(flat, r):
            left = np.roll(q[:, -1], 1)       # __shfl_up_sync by one lane
            left = np.where(lane == 0, q[:, -1], left)
            load = (lane == 0) & (first > 0) & (first < n)
            left[load] = f[first[load] - 1]
            prev = np.concatenate([left[:, None], q[:, :-1]], axis=1)
            start |= q != prev
        start &= valid
        live = start & valid & (r[0] != SENTINEL_KEY)
        end = t0 + RL_TILE
        fwd = _forward_start(flat, end, n, m)[0] if end < n else n
        has = start.any(1)
        mine = first + np.argmax(start, 1)
        firsts = np.full(RL_WARPS + 1, n, np.int64)
        for w in range(RL_WARPS):
            lanes = np.nonzero(has & (warp == w))[0]
            if len(lanes):
                firsts[w] = mine[lanes[0]]
        firsts[RL_WARPS] = fwd
        for th in np.nonzero(has)[0]:
            later = [x for x in range(th + 1, (warp[th] + 1) * 32) if has[x]]
            if later:
                after, how = mine[later[0]], "warp"
            else:
                block = firsts[warp[th] + 1:RL_WARPS]
                after = min(block.min(initial=n), fwd)
                how = ("block" if block.min(initial=n) < n else
                       "forward" if fwd < n else "end")
            bits = np.nonzero(start[th])[0]
            for a, b in zip(bits, list(bits[1:]) + [None]):
                nxt = first[th] + b if b is not None else after
                if paths is not None:
                    key = "thread" if b is not None else how
                    paths[key] = paths.get(key, 0) + 1
                if live[th, a]:
                    counts[first[th] + a] = nxt - (first[th] + a)
    return counts.reshape(G, m)


def _groups(g, G, m, W, hi=3, dead=0.2):
    """W int64 planes (G, m) drawn from `hi` values, a share of sentinel
    rows, each group sorted lexicographically."""
    planes = [g.integers(0, hi, (G, m)) for _ in range(W)]
    gone = g.random((G, m)) < dead
    planes = [np.where(gone, SENTINEL_KEY, p) for p in planes]
    order = np.lexsort(planes[::-1], axis=-1)
    return [np.take_along_axis(p, order, 1) for p in planes]


def _plain(planes):
    return gk.run_lengths_grouped_ref(
        [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]).numpy()


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 3, 33, 128, 1000, 4096])
def test_k2a_model_equals_plain(m, W):
    g = np.random.default_rng(m * 10 + W)
    G = max(2, 6000 // m)
    planes = _groups(g, G, m, W, hi=3 if m < 100 else 4)
    np.testing.assert_array_equal(k2a_model(planes), _plain(planes))


def _edge(name):
    if name == "fill_group":
        return [np.full((3, 4096), 7, np.int64)]
    if name == "cross_tile":
        x = np.full((3, 4096), 9, np.int64)
        x[:, RL_TILE - 24:3 * RL_TILE + 5] = 11      # over two tile ends
        x[:, 3 * RL_TILE + 5:] = SENTINEL_KEY
        return [x, x.copy()]
    if name == "sentinels_only":
        return [np.full((40, 256), SENTINEL_KEY, np.int64)] * 2
    if name == "sentinel_groups_mixed":
        g = np.random.default_rng(5)
        p = _groups(g, 30, 256, 1, hi=2, dead=0.0)
        p[0][10:20] = SENTINEL_KEY
        return p
    if name == "run_ends_at_tile_end":
        x = np.zeros((2, RL_TILE), np.int64)
        x[:, RL_TILE // 2:] = 1
        return [x]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["fill_group", "cross_tile",
                                  "sentinels_only", "sentinel_groups_mixed",
                                  "run_ends_at_tile_end"])
def test_k2a_model_edges(name):
    planes = _edge(name)
    got = k2a_model(planes)
    np.testing.assert_array_equal(got, _plain(planes))
    if name == "fill_group":
        assert got[:, 0].tolist() == [4096] * 3 and not got[:, 1:].any()
    if name == "sentinels_only":
        assert not got.any()


def test_k2a_every_path_and_forward_bound():
    """The edge cases reach the next start by each path, and the forward
    scan past a tile's end reads at most one group (after the warp's 32
    rows, m / RL_TILE + 1 block steps)."""
    paths = {}
    for name in ("fill_group", "cross_tile", "sentinel_groups_mixed"):
        k2a_model(_edge(name), paths)
    k2a_model(_groups(np.random.default_rng(1), 40, 1000, 1), paths)
    k2a_model(_groups(np.random.default_rng(2), 700, 3, 1), paths)
    assert {"thread", "warp", "block", "forward"} <= set(paths)
    for m in (3, 128, 1000, 4096):
        x = np.zeros((4, m), np.int64)
        flat = [x.reshape(-1)]
        n = x.size
        for e in range(1, n, 97):
            row, steps = _forward_start(flat, e, n, m)
            assert row == min(-(-e // m) * m, n)
            assert steps <= m // RL_TILE + 1


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 40), st.integers(1, 700), st.integers(1, 4),
       st.integers(2, 6), st.integers(0, 2**32 - 1))
def test_k2a_model_any_groups(G, m, W, hi, seed):
    planes = _groups(np.random.default_rng(seed), G, m, W, hi=hi)
    np.testing.assert_array_equal(k2a_model(planes), _plain(planes))


@pytest.mark.parametrize("k,m", [(11, 128), (21, 256), (31, 384),
                                 (16, 512)])
def test_k2a_model_equals_pallas(k, m):
    """The model, lane for lane, against kmer_tpu's K2a in interpret mode
    on the same group-sorted keys (G = 64, kmer_tpu's block of groups)."""
    g = np.random.default_rng(k + m)
    pool = g.integers(0, 1 << (2 * k), 30)
    keys = pool[g.integers(0, 30, (64, m))]
    keys[g.random((64, m)) < 0.15] = SENTINEL_KEY
    keys = np.sort(keys, axis=1)
    rw = [jnp.asarray(w) for w in words_to_tpu_repacked(keys, k)]
    want = np.asarray(run_lengths_grouped_pallas(rw, interpret=True))
    planes = [words_from_tpu_repacked([np.asarray(w) for w in rw], k)]
    np.testing.assert_array_equal(k2a_model(planes), want)
