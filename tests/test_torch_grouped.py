"""The grouped counts (kernels K2a, K2b, K2c's plain versions in
ops/kernels/grouped_count, and ops/count.grouped_count / sort_count)
against kmer_tpu: the Pallas kernels in interpret mode, fed the same
group-sorted keys through kmer_tpu's repacked layout
(ops/encode.words_to_tpu_repacked / words_from_tpu_repacked), and
kmer_tpu's ops/count on the same extracted keys.  Inputs come from
np.random.default_rng; every comparison is exact.  The CUDA kernels are
held against the plain versions in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops import count as jax_count
from kmer_tpu.ops.canonical import canonical_kmer_lanes as jax_canonical
from kmer_tpu.ops.extract import kmer_lanes as jax_kmer_lanes
from kmer_tpu.ops.pallas.fused_count import (fused_grouped_count,
                                             fused_grouped_count_sublane,
                                             run_lengths_grouped_pallas)
from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu_torch.ops import count as count_ops
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, keys_u32_to_i64,
                                       words_from_tpu_repacked,
                                       words_to_tpu_repacked)
from kmer_tpu_torch.ops.kernels import compact as ck
from kmer_tpu_torch.ops.kernels import grouped_count as gk
from kmer_tpu_torch.pipeline.table import KmerTable, device_run_pairs


def _keys(rng, k, shape, distinct=40, dead=0.15):
    """int64 keys of k bases drawn from `distinct` values (duplicates),
    a share of SENTINEL_KEY lanes."""
    pool = rng.integers(0, 1 << (2 * k), distinct)
    keys = pool[rng.integers(0, distinct, shape)]
    keys[rng.random(shape) < dead] = SENTINEL_KEY
    return keys


def _sorted_groups(keys):
    """Each row sorted (int64 order: SENTINEL_KEY last)."""
    return np.sort(keys, axis=1)


def _table(k, keys, counts):
    fused, c = device_run_pairs(keys, counts)
    return KmerTable.from_fused(k, fused, c)


def _jax_table(k, rwords, counts):
    """kmer_tpu's live (key, count) lanes of a repacked run stream."""
    cc = np.asarray(counts).reshape(-1)
    keys = words_from_tpu_repacked([np.asarray(w).reshape(-1)
                                    for w in rwords], k)
    return _table(k, keys, cc)


@pytest.mark.parametrize("k", [11, 16, 21, 31])
def test_run_lengths_plain_equals_pallas(k):
    """K2a, lane for lane, on fully sorted groups (G=64, m=128)."""
    rng = np.random.default_rng(k)
    keys = _sorted_groups(_keys(rng, k, (64, 128)))
    rw = [jnp.asarray(w) for w in words_to_tpu_repacked(keys, k)]
    want = np.asarray(run_lengths_grouped_pallas(rw, interpret=True))
    # the port's planes are kmer_tpu's words carried across
    planes = [torch.from_numpy(words_from_tpu_repacked(
        [np.asarray(w) for w in rw], k))]
    got = gk.run_lengths_grouped(planes)
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((keys != SENTINEL_KEY).sum())


@pytest.mark.parametrize("k", [9, 15, 21, 31])
def test_grouped_plain_equals_pallas(k):
    """K2b: kmer_tpu's table; lane for lane where the key is one word
    (k <= 15; wider kmer_tpu keys sort by their top word alone)."""
    rng = np.random.default_rng(50 + k)
    keys = _keys(rng, k, (64, 128))
    rw = [jnp.asarray(w) for w in words_to_tpu_repacked(keys, k)]
    s, counts = fused_grouped_count(rw, interpret=True)
    got_s, got_c = gk.grouped_count([torch.from_numpy(keys)])
    assert _table(k, got_s[0].numpy(), got_c.numpy()) == _jax_table(k, s,
                                                                     counts)
    np.testing.assert_array_equal(got_s[0].numpy(), _sorted_groups(keys))
    if k <= 15:
        np.testing.assert_array_equal(
            got_s[0].numpy(),
            words_from_tpu_repacked([np.asarray(w) for w in s], k))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(counts))


@pytest.mark.parametrize("k", [13, 21])
def test_strided_plain_equals_pallas(k):
    """K2c at m=8: groups are the columns of an (8, 512) array."""
    rng = np.random.default_rng(70 + k)
    keys = _keys(rng, k, (8, 512), distinct=12)
    rw = [jnp.asarray(w) for w in words_to_tpu_repacked(keys, k)]
    s, counts = fused_grouped_count_sublane(rw, interpret=True)
    got_s, got_c = gk.grouped_count_strided([torch.from_numpy(keys)])
    assert got_s[0].shape == got_c.shape == (8, 512)
    assert _table(k, got_s[0].numpy(), got_c.numpy()) == _jax_table(k, s,
                                                                     counts)
    np.testing.assert_array_equal(got_s[0].numpy(),
                                  np.sort(keys, axis=0))
    # runs never leave their column
    want_c = gk.grouped_count([torch.from_numpy(keys.T.copy())])[1]
    np.testing.assert_array_equal(got_c.numpy(), want_c.numpy().T)


def _extracted(seed, k, canonical, amb=False, B=30, L=90):
    """kmer_tpu's std words + valid and the port's int64 keys of one
    random batch."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    # a small genome's reads: many repeated k-mers
    codes[B // 2:] = codes[:B - B // 2]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    fn = jax_canonical if canonical else jax_kmer_lanes
    words, valid = fn(jnp.asarray(codes), jnp.asarray(lengths), k,
                      limits=jnp.asarray(limits), mask_ambiguous=amb)
    keys = keys_u32_to_i64(
        np.stack([np.asarray(w).reshape(-1) for w in words], 1), k)
    return words, valid, keys


@pytest.mark.parametrize("backend", list(count_ops.GROUPED_BACKENDS))
@pytest.mark.parametrize("k", [15, 21, 31])
def test_grouped_count_backends_equal_kmer_tpu(k, backend):
    words, valid, keys = _extracted(k, k, canonical=True)
    s, is_start, counts = jax_count.grouped_count(words, valid, k, 128,
                                                  backend="xla")
    sel = np.asarray(is_start) & (np.asarray(counts) > 0)
    ks = np.stack([np.asarray(w) for w in s], 1)
    want = JaxTable.from_pairs(k, ks[sel], np.asarray(counts)[sel])
    m = 8 if backend == "pallas_t" else 128
    flat, got_c = count_ops.grouped_count([torch.from_numpy(keys)], m,
                                          backend=backend)
    assert got_c.dtype == torch.int32
    assert flat[0].numel() == got_c.numel() == -(-keys.size // m) * m
    assert _table(k, flat[0].numpy(), got_c.numpy()) == want


@pytest.mark.parametrize("k,canonical,amb", [(5, False, False),
                                             (21, True, False),
                                             (31, False, True)])
def test_sort_count_equals_kmer_tpu(k, canonical, amb):
    words, _, keys = _extracted(200 + k, k, canonical, amb)
    s, _, counts = jax_count.sort_count(words)
    want_keys = keys_u32_to_i64(
        np.stack([np.asarray(w).reshape(-1) for w in s], 1), k)
    (got,), got_c = count_ops.sort_count([torch.from_numpy(keys)])
    np.testing.assert_array_equal(got.numpy(), want_keys)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(counts))


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("m", [1, 2, 3, 128, 300])
def test_run_lengths_grouped_any_m(W, m):
    """K2a's plain version on W-word rows at any m equals a numpy run
    scan; G=1 and sentinel rows included."""
    rng = np.random.default_rng(W * 1000 + m)
    for G in (1, 5):
        rows = rng.integers(0, 3, (G, m, W))
        rows[rng.random((G, m)) < 0.2] = SENTINEL_KEY
        order = np.lexsort(rows.transpose(2, 0, 1)[::-1], axis=1)
        rows = np.take_along_axis(rows, order[..., None], axis=1)
        planes = [torch.from_numpy(rows[..., q].copy()) for q in range(W)]
        got = gk.run_lengths_grouped(planes).numpy()
        want = np.zeros((G, m), np.int32)
        for g in range(G):
            i = 0
            while i < m:
                j = i
                while j + 1 < m and (rows[g, j + 1] == rows[g, i]).all():
                    j += 1
                if rows[g, i, 0] != SENTINEL_KEY:
                    want[g, i] = j - i + 1
                i = j + 1
        np.testing.assert_array_equal(got, want)


def test_grouped_edges():
    """One run filling a group, all sentinels, m = 2, G = 1."""
    one_run = torch.full((3, 128), 7, dtype=torch.int64)
    s, c = gk.grouped_count([one_run])
    assert c[:, 0].tolist() == [128] * 3 and int(c[:, 1:].abs().sum()) == 0
    dead = torch.full((4, 16), SENTINEL_KEY, dtype=torch.int64)
    assert int(gk.grouped_count([dead, dead])[1].abs().sum()) == 0
    assert int(gk.grouped_count_strided([dead])[1].abs().sum()) == 0
    pairs = torch.tensor([[5, 5, 9, 1]], dtype=torch.int64).view(2, 2)
    s, c = gk.grouped_count([pairs])
    assert s[0].tolist() == [[5, 5], [1, 9]] and c.tolist() == [[2, 0],
                                                                [1, 1]]
    s, c = gk.grouped_count_strided([pairs])
    assert s[0].tolist() == [[5, 1], [9, 5]] and c.tolist() == [[1, 1],
                                                                [1, 1]]
    s, c = gk.grouped_count_strided([pairs.T.contiguous()])
    assert s[0].tolist() == [[5, 1], [5, 9]] and c.tolist() == [[2, 1],
                                                                [0, 1]]


def test_max_group_rows_and_checks():
    assert [gk.max_group_rows(w) for w in (1, 2, 3, 4)] == [16384, 8192,
                                                            8192, 4096]
    x = torch.zeros((4, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        gk.grouped_count([torch.zeros((4, 6), dtype=torch.int64)])
    with pytest.raises(ValueError, match=f"1 to {gk.MAX_WORDS}"):
        gk.run_lengths_grouped([x] * (gk.MAX_WORDS + 1))
    with pytest.raises(ValueError, match="int64"):
        gk.grouped_count([x.to(torch.int32)])
    with pytest.raises(ValueError, match="contiguous"):
        gk.grouped_count_strided([x.T])
    with pytest.raises(ValueError, match="meta"):
        gk.run_lengths_grouped([x.to("meta")])
    before = (gk.run_lengths_launches, gk.grouped_launches,
              gk.strided_launches)
    gk.run_lengths_grouped([x])
    gk.grouped_count([x])
    gk.grouped_count_strided([x])
    assert (gk.run_lengths_launches, gk.grouped_launches,
            gk.strided_launches) == before


@pytest.mark.parametrize("backend,W,m,want", [
    ("auto", 1, 256, "hybrid"), ("auto", 2, 256, "dedup"),
    ("auto", 2, 12, "hybrid"), ("xla", 1, 256, "hybrid"),
    ("hybrid", 1, 100, "hybrid"), ("pallas", 1, 256, "pallas"),
    ("pallas", 1, 64, "hybrid"), ("pallas", 1, 200, "hybrid"),
    ("pallas", 4, 8192, "hybrid"), ("pallas_t", 1, 16, "pallas_t"),
    ("pallas_t", 1, 24, "hybrid"), ("dedup", 1, 256, "dedup")])
def test_backend_policy(backend, W, m, want):
    assert count_ops._resolve_backend(backend, W, m) == want


def test_backend_errors(monkeypatch):
    keys = [torch.arange(100, dtype=torch.int64)]
    with pytest.raises(ValueError, match="KMER_TPU_GROUPED"):
        count_ops.grouped_count(keys, 16, backend="hash1")
    monkeypatch.setenv("KMER_TPU_DEDUP_SEG", "3")
    with pytest.raises(ValueError, match="KMER_TPU_DEDUP_SEG"):
        count_ops.grouped_count(keys, 16, backend="dedup")
    monkeypatch.setenv("KMER_TPU_DEDUP_SEG", "4")
    monkeypatch.setenv("KMER_TPU_GROUPED", "dedup")
    flat, c = count_ops.grouped_count(keys, 16)
    assert int(c.sum()) == 100 and flat[0].numel() == 112


@pytest.mark.parametrize("count_dtype", [torch.int8, torch.int32])
def test_compact_takes_int32_counts(count_dtype):
    """K4's plain version on the unfused step's int32 counts gives the
    records it gives on the same counts as int8."""
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.integers(0, 1 << 42, 5000))
    counts = torch.from_numpy(rng.integers(0, 4, 5000).astype(np.int32))
    got = ck.compact((keys,), counts.to(count_dtype))
    want = ck.compact((keys,), counts.to(torch.int8))
    t = int(want[2][0])
    assert int(got[2][0]) == t == int((counts > 0).sum())
    assert torch.equal(got[0][:t], want[0][:t])
    assert torch.equal(got[1][:t], want[1][:t])
    rec_k, rec_c, total = count_ops.grouped_count_compact(
        [keys], 256, backend="hybrid")
    t = int(total[0])
    assert _table(21, rec_k[:t].numpy(), rec_c[:t].numpy()) == _table(
        21, keys.numpy(), np.ones(5000, np.int64))
