"""A numpy model of kernel K6's hybrid MSD radix sort (csrc/sort.cu), run
on the CPU: the same levels (the static top digit of key word 0, then
each bucket's AND/OR-chosen window under its highest varying bit), the
same filing of children (next-level buckets, packed local tiles, copies
of done rows that lie in the second buffer) and the same local sort (LSD
passes over only the 8-bit windows that cover a tile's varying bits).
It checks what the CUDA source cannot show here: that the rows come out
as the plain version and numpy's stable lexsort put them, payload order
included, that no work list outgrows the capacity `sort.plan` sizes,
and that no bucket outlives the plan's levels.  Small local tiles and
runs drive many levels at small sizes; one case runs the kernel's own.
The kernel itself is held against the plain version on the card in
test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from kmer_tpu_torch.ops.kernels import sort as sk

SENT = np.int64(sk.SENTINEL)
U = np.uint64


def _code(v, b):
    """csrc/sort.cu code_of: uint64 codes whose order is the key order."""
    if b < 64:
        return np.where(v == SENT, U(1 << b), v.astype(U))
    return v.view(U) ^ U(1 << 63)


def _and_or(c):
    return int(np.bitwise_and.reduce(c)), int(np.bitwise_or.reduce(c))


def _sig(b):
    return b + 1 if b < 64 else 64


def _lsd(key, order):
    """csrc/sort.cu lsd_windows: stable passes of `order` (indices into
    key) over the 8-bit windows covering key's varying bits, lowest
    first; (order, passes)."""
    a, o = _and_or(key)
    rest, passes = a ^ o, 0
    while rest:
        lo = (rest & -rest).bit_length() - 1
        rest &= ~((1 << (lo + 8)) - 1)
        d = (key[order] >> U(lo)) & U(255)
        order = order[np.argsort(d, kind="stable")]
        passes += 1
    return order, passes


def _fix_runs(rows, K, bits, qf, perm, fix_max):
    """csrc/sort.cu fix_runs: the runs of equal word-qf codes in order by
    the later words, through a sub-list of the runs that hold a
    difference; None past fix_max rows."""
    c = _code(rows[qf], bits[qf])[perm]
    head = np.ones(len(perm), bool)
    head[1:] = c[1:] != c[:-1]
    diff = np.zeros(len(perm), bool)
    for q in range(qf + 1, K):
        w = rows[q][perm]
        diff[1:] |= w[1:] != w[:-1]
    diff &= ~head
    if not diff.any():
        return perm, 0
    rid = np.cumsum(head) - 1
    need = np.zeros(rid[-1] + 1, bool)
    need[rid[diff]] = True
    pos = np.nonzero(need[rid])[0]
    if len(pos) > fix_max:
        return None, len(pos)
    sub = np.arange(len(pos))
    for q in range(K - 1, qf - 1, -1):
        key = (_code(rows[q][perm[pos]], bits[q]) if q > qf
               else rid[pos].astype(U))
        sub, _ = _lsd(key, sub)
    out = perm.copy()
    out[pos] = perm[pos[sub]]
    return out, len(pos)


def _distinct(c):
    """csrc/sort.cu distinct_codes: linear counting over 8192 hash bits."""
    h = (c * U(0x9E3779B97F4A7C15)) >> U(51)
    bits_set = len(np.unique(h))
    if bits_set >= sk.LOCAL_ROWS:
        return float(sk.LOCAL_ROWS)
    return -sk.LOCAL_ROWS * np.log(1 - bits_set / sk.LOCAL_ROWS)


def _local_sort(rows, K, bits, q_start, fix_max, stats):
    """csrc/sort.cu local_kernel on one tile's key rows: (order, passes,
    stats)."""
    m = len(rows[0])
    qf = q_start
    c = _code(rows[qf], bits[qf])
    while _and_or(c)[0] == _and_or(c)[1] and qf + 1 < K:
        qf += 1
        c = _code(rows[qf], bits[qf])

    def wordwise():
        order, passes = np.arange(m), 0
        for q in range(K - 1, qf - 1, -1):
            order, more = _lsd(_code(rows[q], bits[q]), order)
            passes += more
        return order, passes
    varies = _and_or(c)[0] != _and_or(c)[1]
    if qf + 1 < K and varies and m - _distinct(c) > fix_max:
        stats["wordwise"] = stats.get("wordwise", 0) + 1
        perm, passes = wordwise()
        return perm, passes, stats
    perm, passes = _lsd(c, np.arange(m))
    if passes and qf + 1 < K:
        fixed, ms = _fix_runs(rows, K, bits, qf, perm, fix_max)
        stats["fix_rows"] = stats.get("fix_rows", 0) + ms
        if fixed is None:                  # the whole tile, word by word
            stats["fallbacks"] = stats.get("fallbacks", 0) + 1
            perm, passes = wordwise()
        else:
            perm = fixed
    return perm, passes, stats


def msd_model(words, num_keys, bits, local, run, fix_max=None):
    """(sorted planes, stats) as the kernel computes them, list by list."""
    fix_max = local // 2 if fix_max is None else fix_max
    n, W, K = len(words[0]), len(words), num_keys
    p = sk.plan(n, W, K, bits, local_rows=local, run_rows=run)
    # a one-level plan starts from a copy in the second buffer, whatever n
    flip = int(p["levels"] == 1)
    bufs = [[w.copy() for w in words],
            [w.copy() if flip else np.zeros_like(w) for w in words]]
    tiles = []                     # (start, size, q_start, src, copy)
    cur = [(0, n, 0)] if n > local or flip else []
    if not cur:
        tiles.append((0, n, 0, 0, False))
    stats = {"levels_used": 0, "max_buckets": 0, "max_runs": 0}

    def file_copy(st, sz):
        tiles.extend((st + c, min(local, sz - c), 0, 1, True)
                     for c in range(0, sz, local))

    for level in range(p["levels"]):
        src = (level + flip) & 1
        dst = src ^ 1
        runs = sum(-(-sz // run) for _, sz, _ in cur)
        assert len(cur) <= p["cap_buckets"] and runs <= p["cap_runs"]
        stats["max_buckets"] = max(stats["max_buckets"], len(cur))
        stats["max_runs"] = max(stats["max_runs"], runs)
        if cur:
            stats["levels_used"] = level + 1
        nxt = []
        for st, sz, q0 in cur:
            sl = slice(st, st + sz)
            if level == 0:
                sig = _sig(bits[0])
                q, lo = 0, max(0, sig - 8)
                nb = sig - lo
            else:
                q = None
                for qq in range(q0, K):
                    a, o = _and_or(_code(bufs[src][qq][sl], bits[qq]))
                    if a ^ o:
                        hv = (a ^ o).bit_length() - 1
                        q, lo = qq, max(0, hv - 7)
                        nb = hv - lo + 1
                        break
                if q is None:                        # done where it stands
                    if src == 1:
                        file_copy(st, sz)
                    continue
            d = ((_code(bufs[src][q][sl], bits[q]) >> U(lo))
                 & U((1 << nb) - 1)).astype(np.int64)
            order = np.argsort(d, kind="stable")
            for w in range(W):
                bufs[dst][w][sl] = bufs[src][w][sl][order]
            tot = np.bincount(d, minlength=1 << nb)
            first = st + np.concatenate([[0], np.cumsum(tot)[:-1]])
            # file_children
            q0c = q if lo > 0 else q + 1
            left = q0c < K
            group = [0, 0, False]                   # start, size, sort

            def flush():
                if group[1] and (group[2] or dst == 1):
                    if group[2]:
                        tiles.append((group[0], group[1], q, dst, False))
                    else:
                        file_copy(group[0], group[1])
                group[1], group[2] = 0, False

            for t, f in zip(tot.tolist(), first.tolist()):
                if t == 0:
                    continue
                if t <= local:
                    if group[1] + t > local:
                        flush()
                    if group[1] == 0:
                        group[0] = f
                    group[1] += t
                    group[2] |= left and t > 1
                else:
                    flush()
                    if left:
                        nxt.append((f, t, q0c))
                    elif dst == 1:
                        file_copy(f, t)
            flush()
        cur = nxt
    assert not cur, "a bucket outlived the plan's levels"
    assert len(tiles) <= p["cap_tiles"]
    stats["tiles"] = len(tiles)
    covered = np.zeros(n, np.int64)
    A = bufs[0]
    for st, m, q_start, src, copy in tiles:
        assert 1 <= m <= local
        sl = slice(st, st + m)
        covered[sl] += 1
        if copy:
            assert src == 1
            for w in range(W):
                A[w][sl] = bufs[1][w][sl]
            continue
        rows = [bufs[src][q][sl] for q in range(K)]
        perm, passes, stats = _local_sort(rows, K, bits, q_start, fix_max,
                                          stats)
        if passes == 0 and src == 0:
            continue
        for w in range(W):
            A[w][sl] = bufs[src][w][sl][perm]
    assert covered.max(initial=0) <= 1          # tiles never overlap
    return A, stats


def _cases(rng, n):
    """name -> (planes, num_keys, bits): the distributions the MSD design
    must survive, each with a payload of distinct values."""
    def perm():
        return rng.permutation(n).astype(np.int64)

    def dead(share, *planes):
        gone = rng.random(n) < share
        for p in planes:
            p[gone] = SENT
        return list(planes)

    k21 = rng.integers(0, 1 << 42, n)
    rep = rng.integers(0, 1 << 42, n)
    rep[rng.random(n) < 0.4] = 123_456_789
    low = rng.integers(0, 1 << 20, n)
    # device merge: a sorted unique state padded with sentinels, then a
    # batch with dead lanes
    half = n // 2
    state = np.unique(rng.integers(0, 1 << 42, half // 2))
    merge = np.concatenate([state, np.full(half - state.size, SENT),
                            np.where(rng.random(n - half) < 0.2, SENT,
                                     rng.integers(0, 1 << 42, n - half))])
    srt = np.sort(rng.integers(0, 1 << 42, n))
    b130 = (62, 62, 62, 62, 12)
    # few values in the first three words: lineages reach words 3 and 4
    k130 = dead(0.2, *[rng.integers(0, 8 if q < 3 else 1 << b, n)
                       for q, b in enumerate(b130)])
    b101 = (62, 62, 62, 16)
    k101 = dead(0.3, *[rng.integers(0, 1 << b, n) for b in b101])
    pool = np.array([np.iinfo(np.int64).min, -(1 << 40), -1, 0, 9, 1 << 62,
                     SENT])
    return {
        "k21_random": (dead(0.2, k21) + [perm()], 1, (42,)),
        "one_key_repeated": ([rep, perm()], 1, (42,)),
        "one_top_bucket": ([low, perm()], 1, (42,)),
        "presorted": ([srt, perm()], 1, (42,)),
        "reversed": ([srt[::-1].copy(), perm()], 1, (42,)),
        "devmerge_half_sentinel": ([merge, perm()], 1, (42,)),
        "k55_pairs": (dead(0.2, rng.integers(0, 1 << 62, n),
                           rng.integers(0, 1 << 48, n)) + [perm()], 2,
                      (62, 48)),
        "k101_planes5": (k101 + [perm()], 4, b101),
        "k130_planes6_keys5": (k130 + [perm()], 5, b130),
        "bits64_any": ([pool[rng.integers(0, len(pool), n)],
                        pool[rng.integers(0, len(pool), n)], perm()], 2,
                       (64, 64)),
        "owner_partition": ([rng.integers(0, 4, n), perm(), perm()], 1,
                            (3,)),
        "all_sentinels": ([np.full(n, SENT), perm()], 1, (42,)),
        "all_equal": ([np.full(n, 7), np.full(n, 7), perm()], 2, (5, 64)),
        "planes240": ([rng.integers(0, 5, n), rng.integers(0, 3, n),
                       rng.integers(0, 1 << 16, n)]
                      + [perm() for _ in range(237)], 3, (3, 2, 16)),
    }


def _lexsorted(planes, num_keys):
    order = np.lexsort(planes[:num_keys][::-1])
    return [p[order] for p in planes]


@pytest.mark.parametrize("n,local,run", [(5000, 64, 128), (777, 32, 64),
                                         (40_000, 512, 1024)])
@pytest.mark.parametrize("case", list(_cases(np.random.default_rng(0),
                                             16)))
def test_msd_model_equals_lexsort(case, n, local, run):
    """The model's rows equal the stable lexsort and the plain version,
    and every list stays inside the plan's capacities and levels."""
    rng = np.random.default_rng(n + len(case))
    planes, num_keys, bits = _cases(rng, n)[case]
    got, stats = msd_model(planes, num_keys, bits, local, run)
    want = _lexsorted(planes, num_keys)
    plain = sk.sort_words_ref([torch.from_numpy(p) for p in planes],
                              num_keys, bits)
    for g, w, pl in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(pl.numpy(), w)
    assert stats["levels_used"] <= sk.plan(n, len(planes), num_keys,
                                           bits)["levels"]


def test_msd_model_at_the_kernels_sizes():
    """The kernel's own LOCAL_ROWS and RUN_ROWS on the merge shapes: two
    levels (level 1 finds the sentinel bucket done); a key on 40% of the
    rows takes four, as a few rows share its prefix down to level 2."""
    rng = np.random.default_rng(21)
    n = 300_000
    for case, levels in (("devmerge_half_sentinel", 2),
                         ("one_key_repeated", 4), ("k101_planes5", 2)):
        planes, num_keys, bits = _cases(rng, n)[case]
        got, stats = msd_model(planes, num_keys, bits, sk.LOCAL_ROWS,
                               sk.RUN_ROWS)
        for g, w in zip(got, _lexsorted(planes, num_keys)):
            np.testing.assert_array_equal(g, w)
        assert stats["levels_used"] == levels


def test_msd_model_levels_are_tight():
    """A lineage that peels one row off each level reaches the plan's
    last level and no further: every level's window is needed."""
    local, run = 1, 2
    n = 13
    # keys 0, 1, 2, 4, ..., 2**11 in 12 bits: a split at every bit
    key = np.array([0] + [1 << i for i in range(12)], np.int64)
    got, stats = msd_model([key[::-1].copy()], 1, (11,), local, run)
    np.testing.assert_array_equal(got[0], np.sort(key))
    assert stats["levels_used"] == sk.plan(n, 1, 1, (11,))["levels"] == 2


def test_plan_sizes():
    """plan(): levels by the bits, launches 4 levels + 1, capacities by n;
    the scratch a second set of planes and the lists."""
    p = sk.plan(25_165_824, 2, 1, (42,))
    assert (p["levels"], p["launches"]) == (6, 24)
    assert p["local_rows"] == sk.LOCAL_ROWS == 8192
    assert p["run_rows"] == sk.RUN_ROWS == 4096
    assert p["cap_buckets"] == 25_165_824 // 8193 + 1
    assert p["cap_runs"] == 25_165_824 // 4096 + p["cap_buckets"] + 1
    assert sk.plan(12_582_912, 5, 4, (62, 62, 62, 16))["levels"] == 27
    assert sk.plan(100, 3, 3, (54, 40, 31))["levels"] == 17
    assert sk.plan(100, 5, 1, (3,))["launches"] == 3   # owner partition
    assert sk.plan(100, 2, 2, (64, 0))["levels"] == 9
    p = sk.plan(1000, 3, 2, (62, 48))
    assert p["rec_words"] == 9
    assert p["scratch_words"] == (
        3 * 1000 + 256 * (p["cap_runs"] + 1) + 2 * p["cap_runs"]
        + 2 * p["cap_buckets"] * 9 + 2 * p["cap_tiles"]
        + 2 * (p["levels"] + 1) + 1)
    # the scratch stays within a few percent of the second set of planes
    for W, bits in ((2, (42,)), (3, (62, 48)), (5, (62, 62, 62, 16))):
        n = 25_165_824
        extra = sk.plan(n, W, len(bits), bits)["scratch_words"] - W * n
        assert extra < 0.15 * n


@pytest.mark.parametrize("fix_max,fallback", [(512, False), (8, True)])
def test_msd_model_runs_fixed_by_later_words(fix_max, fallback):
    """Rows that tie on their first varying key word: near-duplicate pairs
    (a k = 55 key and its copy with another lo, as a read error late in
    the k-mer makes), runs of a repeated (hi, lo) with varying counts (the
    parity rows) and exact duplicates.  The local sort fixes them through
    its sub-list, or, past fix_max tied rows, sorts the tile word by word
    (up front where its estimate of the distinct first words says so, or
    after its sub-list grew too long); either way the rows equal
    lexsort's."""
    rng = np.random.default_rng(fix_max)
    n = 3000
    hi = rng.integers(0, 1 << 62, n)
    lo = rng.integers(0, 1 << 48, n)
    twin = rng.random(n) < 0.1                  # hi of the row before
    hi[1:][twin[1:]] = hi[:-1][twin[1:]]
    rep = rng.random(n) < 0.05                  # one (hi, lo), many rows
    hi[rep], lo[rep] = 12345, 678
    count = rng.integers(1, 4, n)
    dup = rng.random(n) < 0.1                   # exact copies of row 0
    hi[dup], lo[dup], count[dup] = hi[0], lo[0], count[0]
    planes = [hi, lo, count, rng.permutation(n).astype(np.int64)]
    got, stats = msd_model(planes, 3, (62, 48, 31), 256, 512,
                           fix_max=fix_max)
    for g, w in zip(got, _lexsorted(planes, 3)):
        np.testing.assert_array_equal(g, w)
    assert stats.get("fix_rows", 0) > 0
    assert (stats.get("fallbacks", 0) + stats.get("wordwise", 0) > 0
            ) == fallback
