"""The port's KmerTable against kmer_tpu's: from_pairs on both the numpy
(small) and the native (>= MIN_N pairs) path, from_device_runs on int64
keys, TSV rendering, and .npz files that either package loads."""

import io

import numpy as np
import pytest

from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu.pipeline.table import TableAccumulator as JaxAccumulator
from kmer_tpu_torch.ops.encode import SENTINEL_KEY, keys_i64_to_u32
from kmer_tpu_torch.pipeline import nativeagg
from kmer_tpu_torch.pipeline.table import KmerTable, TableAccumulator


def _pairs(k, n, seed):
    """n random (M, W) uint32 keys with many duplicates, + counts."""
    rng = np.random.default_rng(seed)
    distinct = rng.integers(0, 1 << (2 * k), max(n // 4, 1), dtype=np.int64)
    vals = distinct[rng.integers(0, len(distinct), n)]
    return vals, keys_i64_to_u32(vals, k), rng.integers(1, 9, n)


@pytest.mark.parametrize("n", [1000, nativeagg.MIN_N + 4321])
@pytest.mark.parametrize("k", [5, 16, 21, 31])
def test_from_pairs_matches(k, n):
    _, keys, counts = _pairs(k, n, 10 * k + (n > 1000))
    got = KmerTable.from_pairs(k, keys, counts)
    assert got == JaxTable.from_pairs(k, keys, counts)
    assert got.keys.dtype == np.uint32 and got.counts.dtype == np.int64
    assert got.total == int(counts.sum())
    assert nativeagg.native_loaded() or n < nativeagg.MIN_N


@pytest.mark.parametrize("k", [11, 21])
def test_from_device_runs_drops_sentinels(k):
    vals, keys, counts = _pairs(k, 500, k)
    dev_keys = np.where(np.arange(500) % 7 == 0, SENTINEL_KEY, vals)
    dev_counts = np.where(dev_keys == SENTINEL_KEY, 0, counts).astype(np.int8)
    got = KmerTable.from_device_runs(k, dev_keys.reshape(20, 25),
                                     dev_counts.reshape(20, 25))
    live = dev_counts > 0
    assert got == JaxTable.from_pairs(k, keys[live], counts[live])


def test_npz_loads_in_both_packages(tmp_path):
    for k in (7, 16, 31):
        _, keys, counts = _pairs(k, 300, k)
        t = KmerTable.from_pairs(k, keys, counts)
        j = JaxTable.from_pairs(k, keys, counts)
        t.save(str(tmp_path / "t.npz"))
        j.save(str(tmp_path / "j.npz"))
        assert KmerTable.load(str(tmp_path / "j.npz")) == j
        assert JaxTable.load(str(tmp_path / "t.npz")) == j


@pytest.mark.parametrize("n", [50, 40000])
def test_write_tsv_bytes_match(n):
    """Small tables render in numpy, large ones natively."""
    k = 21
    _, keys, counts = _pairs(k, n, n)
    t = KmerTable.from_pairs(k, keys, counts * 1000003)
    j = JaxTable.from_pairs(k, keys, counts * 1000003)
    a, b = io.StringIO(), io.BytesIO()
    t.write_tsv(a)
    t.write_tsv(b)
    want = io.StringIO()
    j.write_tsv(want)
    assert a.getvalue() == want.getvalue()
    assert b.getvalue() == want.getvalue().encode()
    assert t.to_dict() == j.to_dict()
    ft = t.filter_count_range(3000000, 6000000)
    assert ft == j.filter_count_range(3000000, 6000000)


def test_accumulator_matches():
    k = 13
    ta, ja = TableAccumulator(k, flush_pairs=700), JaxAccumulator(
        k, flush_pairs=700)
    for i in range(9):
        _, keys, counts = _pairs(k, 400, 100 + i)
        ta.add(KmerTable.from_pairs(k, keys, counts))
        ja.add(JaxTable.from_pairs(k, keys, counts))
    ta.add(KmerTable.empty(k))
    assert ta.result() == ja.result()
    assert TableAccumulator(k).result() == JaxTable.empty(k)
    with pytest.raises(ValueError, match="key width"):
        KmerTable.from_pairs(k, np.zeros((3, 2), np.uint32), np.ones(3))
