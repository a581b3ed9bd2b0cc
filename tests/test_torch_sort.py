"""The multiset sort (kernel K6's plain version, ops/kernels/sort) against
kmer_tpu's Pallas K6, sort_words_pallas in interpret mode, and against a
numpy lexsort (stable: with num_keys < W the payload's order within equal
keys too), on inputs from np.random.default_rng; the key widths its
callers promise.  All values are integers: every comparison is exact.
The CUDA kernel is held against the plain version in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops.pallas.sort import sort_words_pallas
from kmer_tpu_torch.ops.count import sort_words
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, keys_i64_to_u32,
                                       pairs_to_u32)
from kmer_tpu_torch.ops.kernels import sort as sk
from kmer_tpu_torch.pipeline.parity import parity_step


def _rows(rng, k, N, pattern):
    """(key planes, counts) int64: one key of k bases, or a gapped 27+27
    (hi, lo) pair for k == 54; a share of sentinel rows with count 0."""
    n_planes, bits = (2, 54) if k == 54 else (1, 2 * k)
    if pattern == "dups":
        planes = [rng.integers(0, 4, N) for _ in range(n_planes)]
    else:
        planes = [rng.integers(0, 1 << bits, N) for _ in range(n_planes)]
    counts = rng.integers(1, 6, N)
    if pattern in ("random", "dups"):
        dead = rng.random(N) < 0.25
    else:
        dead = np.zeros(N, bool)
    if pattern == "sentinels":
        dead[:] = True
    for p in planes:
        p[dead] = SENTINEL_KEY
    counts[dead] = 0
    if pattern in ("presorted", "reversed"):
        order = np.lexsort(planes[::-1])
        planes = [p[order] for p in planes]
        if pattern == "reversed":
            planes = [p[::-1].copy() for p in planes]
    return planes, counts


def _u32_words(planes, k):
    """The rows in kmer_tpu's most-significant-first uint32 words."""
    if k == 54:
        return pairs_to_u32(planes[0], planes[1], 27, 27)
    return keys_i64_to_u32(planes[0], k)


@pytest.mark.parametrize("k,N,pattern", [
    *[(k, N, "random") for k in (5, 21, 31, 54) for N in (1024, 1500,
                                                           4096)],
    (21, 1500, "dups"), (54, 4096, "dups"), (21, 1500, "presorted"),
    (31, 1500, "reversed"), (54, 1500, "reversed"), (21, 1024,
                                                     "sentinels")])
def test_plain_sort_equals_pallas(k, N, pattern):
    rng = np.random.default_rng(k * 10_000 + N)
    planes, counts = _rows(rng, k, N, pattern)
    words = _u32_words(planes, k)
    cols = [words[:, j] for j in range(words.shape[1])]
    cols.append(counts.astype(np.uint32))
    want = sort_words_pallas([jnp.asarray(c) for c in cols], chunk=1024,
                             interpret=True)
    want = np.stack([np.asarray(w) for w in want], axis=1)
    got = sort_words([torch.from_numpy(p) for p in planes]
                     + [torch.from_numpy(counts)])
    got = [g.numpy() for g in got]
    np.testing.assert_array_equal(_u32_words(got[:-1], k), want[:, :-1])
    np.testing.assert_array_equal(got[-1], want[:, -1].astype(np.int64))


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [0, 1, 2, 777, 5000])
def test_plain_sort_equals_lexsort(W, N):
    rng = np.random.default_rng(W * 100 + N)
    hi = [1 << 62, 1 << 40, 9, 3][W - 1]       # wide to heavily duplicated
    planes = [rng.integers(0, hi, N) for _ in range(W)]
    if N:
        planes[0][rng.random(N) < 0.1] = SENTINEL_KEY
    order = np.lexsort(planes[::-1])
    got = sort_words([torch.from_numpy(p) for p in planes])
    assert len(got) == W
    for g, p in zip(got, planes):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), p[order])


KEY_BITS = (42, 20, 3, 62)          # a key word's value bits, by position


def _keyed_rows(rng, W, num_keys, N, case):
    """(planes, bits): num_keys key words (heavily duplicated, a share of
    all-sentinel rows) then payload words of distinct values, so that the
    payload shows the order within equal keys."""
    bits = [64 if case == "bits64" else KEY_BITS[q] for q in range(num_keys)]
    if case == "bits64":        # negatives, INT64_MIN and a real INT64_MAX
        pool = np.array([np.iinfo(np.int64).min, -(1 << 40), -1, 0, 5,
                         1 << 62, SENTINEL_KEY])
        keys = [pool[rng.integers(0, len(pool), N)] for _ in bits]
    else:
        keys = [rng.integers(0, min(1 << b, 5), N) for b in bits]
        keys[0][rng.random(N) < 0.5] = rng.integers(0, 1 << bits[0])
        dead = rng.random(N) < (1.0 if case == "sentinels" else 0.15)
        for k in keys:
            k[dead] = SENTINEL_KEY
    payload = [rng.permutation(N).astype(np.int64) - N // 2
               for _ in range(W - num_keys)]
    return keys + payload, bits


@pytest.mark.parametrize("case", ["random", "sentinels", "bits64"])
@pytest.mark.parametrize("W,num_keys", [(W, K) for W in (1, 2, 3, 4)
                                        for K in range(1, W + 1)])
def test_plain_sort_keys_and_payload_equal_lexsort(W, num_keys, case):
    """num_keys key words with bits promises, the rest payload: the rows
    in numpy's stable lexsort order of the key words, payload order within
    equal keys included."""
    rng = np.random.default_rng(W * 10 + num_keys)
    planes, bits = _keyed_rows(rng, W, num_keys, 3001, case)
    order = np.lexsort(planes[:num_keys][::-1])
    got = sort_words([torch.from_numpy(p) for p in planes],
                     num_keys=num_keys, bits=bits)
    for g, p in zip(got, planes):
        np.testing.assert_array_equal(g.numpy(), p[order])
    if num_keys == W:           # all keys: as without num_keys and bits
        same = sort_words([torch.from_numpy(p) for p in planes])
        assert all(torch.equal(a, b) for a, b in zip(got, same))


def test_plain_sort_checks_bits_and_keys():
    x = torch.tensor([3, 7, SENTINEL_KEY, 0])
    assert sk.sort_words_ref([x], bits=[3])[0].tolist() == [0, 3, 7,
                                                            SENTINEL_KEY]
    with pytest.raises(ValueError, match="outside"):
        sk.sort_words_ref([x], bits=[2])
    with pytest.raises(ValueError, match="outside"):
        sk.sort_words([x, -x], bits=[3, 63])
    for num_keys, bits in ((0, None), (3, None), (1, [3, 3]), (1, [65]),
                           (2, [3, -1])):
        with pytest.raises(ValueError, match="num_keys|bits"):
            sk.sort_words([x, x], num_keys=num_keys, bits=bits)


def test_sort_words_flattens_and_leaves_cpu_inputs():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 50, (6, 7)))
    b = torch.from_numpy(rng.integers(0, 50, (6, 7)))
    keep = a.clone()
    sa, sb = sort_words([a, b])
    assert sa.shape == (42,) and torch.equal(a, keep)
    order = np.lexsort((b.numpy().reshape(-1), a.numpy().reshape(-1)))
    np.testing.assert_array_equal(sa.numpy(), a.numpy().reshape(-1)[order])
    np.testing.assert_array_equal(sb.numpy(), b.numpy().reshape(-1)[order])


def test_sort_words_rejects_bad_planes():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match=f"1 to {sk.MAX_WORDS}"):
        sk.sort_words([])
    with pytest.raises(ValueError, match=f"1 to {sk.MAX_WORDS}"):
        sk.sort_words([x] * (sk.MAX_WORDS + 1))
    with pytest.raises(ValueError, match="int64"):
        sk.sort_words([x, x.to(torch.int32)])
    with pytest.raises(ValueError, match="one length"):
        sk.sort_words([x, x[:4]])
    with pytest.raises(ValueError, match="meta"):
        sk.sort_words([x.to("meta")])
    before = sk.launches
    sk.sort_words([x])
    assert sk.launches == before        # the plain version launches nothing


def test_parity_and_sort_count_pass_key_bits(monkeypatch):
    """parity_step sorts by (hi, lo, count) with bits (2 l, 2 r, 31);
    the unfused sort_group_keys=0 step sorts every key word at its
    width (ops/encode.plane_bits)."""
    from kmer_tpu_torch.ops import count as count_ops
    from kmer_tpu_torch.ops.encode import plane_bits
    from kmer_tpu_torch.pipeline import count as tcount
    from kmer_tpu_torch.pipeline import parity
    seen = []
    orig = count_ops.sort_words

    def spy(words, num_keys=None, bits=None):
        seen.append((len(words), num_keys, bits))
        return orig(words, num_keys, bits)
    monkeypatch.setattr(parity, "sort_words", spy)
    monkeypatch.setattr(count_ops, "sort_words", spy)
    rng = np.random.default_rng(9)
    B, L = 4, 150
    args = [torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8)),
            torch.full((B,), L, dtype=torch.int32),
            torch.full((B,), L, dtype=torch.int32)]
    parity_step(*args, c_min=80, c_max=100, l_len=27, r_len=20)
    assert seen.pop() == (3, None, (54, 40, 31))
    for k in (21, 45, 63):
        tcount.count_step_sort(*args, k=k, canonical=True, group_keys=0)
        assert seen.pop() == (len(plane_bits(k)), None, plane_bits(k))
    assert plane_bits(21) == (42,) and plane_bits(45) == (62, 28)
    assert plane_bits(63) == (62, 64)


def test_parity_step_sorts_live_rows():
    """parity_step's rows: the live (hi, lo, count) lanes of the gapped
    step, in lexicographic (hi, lo) order, counts int64."""
    from kmer_tpu_torch.pipeline.count import gapped_step_sort
    rng = np.random.default_rng(8)
    B, L = 16, 200
    args = [torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32)),
            torch.full((B,), L, dtype=torch.int32)]
    win = dict(c_min=80, c_max=140, l_len=27, r_len=27)
    hi, lo, counts = parity_step(*args, **win)
    assert counts.dtype == torch.int64 and int(counts.min()) > 0
    h, l_, c = gapped_step_sort(*args, **win)
    live = c.reshape(-1) > 0
    h, l_, c = (x.reshape(-1)[live].numpy() for x in (h, l_, c))
    order = np.lexsort((c, l_, h))
    np.testing.assert_array_equal(hi.numpy(), h[order])
    np.testing.assert_array_equal(lo.numpy(), l_[order])
    np.testing.assert_array_equal(counts.numpy(), c[order])


def _signed_u32(planes):
    """int64 planes as kmer_tpu's uint32 words, most significant first:
    each word's high half with its sign bit flipped, then its low half,
    so that unsigned word order is signed int64 order."""
    cols = []
    for p in planes:
        u = p.view(np.uint64)
        cols += [((u >> np.uint64(32)) ^ np.uint64(1 << 31)).astype(np.uint32),
                 (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    return cols


def _adversarial(rng, case, n):
    """(planes, num_keys, bits) of the distributions K6's MSD levels must
    survive (tests/test_torch_cuda.py and chip_smoke.py phase 13 run them
    on the card); the payload is a permutation, so order within equal
    keys shows."""
    def perm():
        return rng.permutation(n).astype(np.int64)
    if case == "one_key_repeated":
        key = rng.integers(0, 1 << 42, n)
        key[rng.random(n) < 0.4] = 123_456_789
        return [key, perm()], 1, (42,)
    if case == "one_top_bucket":
        return [rng.integers(0, 1 << 20, n), perm()], 1, (42,)
    if case in ("presorted", "reversed"):
        key = np.sort(rng.integers(0, 1 << 42, n))
        return [key if case == "presorted" else key[::-1].copy(),
                perm()], 1, (42,)
    if case == "devmerge_half_sentinel":
        half = n // 2
        state = np.unique(rng.integers(0, 1 << 42, half // 2))
        batch = rng.integers(0, 1 << 42, n - half)
        batch[rng.random(n - half) < 0.2] = SENTINEL_KEY
        key = np.concatenate([state, np.full(half - state.size,
                                             SENTINEL_KEY), batch])
        return [key, rng.integers(0, 50, n)], 1, (42,)
    if case == "planes6_keys5":
        bits = (62, 62, 62, 62, 12)
        keys = [rng.integers(0, 8 if q < 3 else 1 << b, n)
                for q, b in enumerate(bits)]
        dead = rng.random(n) < 0.2
        for k in keys:
            k[dead] = SENTINEL_KEY
        return keys + [perm()], 5, bits
    if case == "near_duplicates":
        hi, lo = rng.integers(0, 1 << 62, n), rng.integers(0, 1 << 48, n)
        twin = rng.random(n) < 0.2
        hi[1:][twin[1:]] = hi[:-1][twin[1:]]
        dup = rng.random(n) < 0.05
        hi[dup], lo[dup] = hi[0], lo[0]
        return [hi, lo, perm()], 2, (62, 48)
    if case == "fix_fallback":
        hi, lo = rng.integers(0, 1 << 54, n), rng.integers(0, 1 << 54, n)
        count = rng.integers(1, 1001, n)
        hot = rng.permutation(n)[:n // 3]
        hi[hot], lo[hot] = 12345, 678
        return [hi, lo, count], 3, (54, 54, 31)
    assert case == "planes240"
    return ([rng.integers(0, 5, n), rng.integers(0, 3, n),
             rng.integers(0, 1 << 16, n)] + [perm() for _ in range(237)],
            3, (3, 2, 16))


@pytest.mark.parametrize("case", ["one_key_repeated", "one_top_bucket",
                                  "presorted", "reversed",
                                  "devmerge_half_sentinel", "planes6_keys5",
                                  "planes240", "near_duplicates",
                                  "fix_fallback"])
def test_plain_sort_adversarial_equals_kmer_tpu(case):
    """The plain version on K6's adversarial distributions against
    kmer_tpu's sort_words on its XLA backend (KMER_TPU_SORT=xla): the key
    words as uint32 words and the row index last, so that the index column
    is the stable order; every plane, payload included, must be the input
    gathered by it."""
    from kmer_tpu.ops.count import sort_words as tpu_sort_words
    rng = np.random.default_rng(len(case))
    n = 3001
    planes, num_keys, bits = _adversarial(rng, case, n)
    cols = _signed_u32(planes[:num_keys]) + [np.arange(n, dtype=np.uint32)]
    order = np.asarray(tpu_sort_words([jnp.asarray(c) for c in cols],
                                      backend="xla")[-1]).astype(np.int64)
    got = sort_words([torch.from_numpy(p) for p in planes],
                     num_keys=num_keys, bits=bits)
    assert len(got) == len(planes)
    for g, p in zip(got, planes):
        np.testing.assert_array_equal(g.numpy(), p[order])
