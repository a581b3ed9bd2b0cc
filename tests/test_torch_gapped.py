"""The gapped slice module by module against kmer_tpu, exactly (integer
keys and bytes: tolerance zero), on inputs from np.random.default_rng:

- kernel K3's plain version against kmer_tpu's Pallas K3 (interpret mode,
  as kmer_tpu's own tests run it), count lane for lane and as tables;
- gapped_lanes lane for lane;
- the gapped key pair <-> (M, W) uint32 words, W = 1..4;
- KmerTable with W = 3, 4 keys (from_pairs, .npz, TSV, accumulator);
- route_partition, the gapped KmerConfig and the two-word collapse.
The CUDA kernel is held against the plain version in test_torch_cuda.py.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.config import KmerConfig as JaxConfig
from kmer_tpu.io.fasta import pack_batch_codes
from kmer_tpu.ops import count as C
from kmer_tpu.ops.encode import key_words_from_codes
from kmer_tpu.ops.extract import gapped_lanes as jax_gapped_lanes
from kmer_tpu.ops.pallas.fused_gapped import fused_gapped_count_T
from kmer_tpu.pipeline.streaming import route_partition as jax_route
from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu.pipeline.table import TableAccumulator as JaxAccumulator
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.ops.extract import gapped_lane_count, gapped_lanes
from kmer_tpu_torch.ops.kernels import fused_gapped as fg
from kmer_tpu_torch.ops.kernels.fused_count import dedup_runlen
from kmer_tpu_torch.pipeline import nativeagg
from kmer_tpu_torch.pipeline.streaming import route_partition
from kmer_tpu_torch.pipeline.table import (KmerTable, TableAccumulator,
                                           gapped_run_pairs)


def _batch(seed, B, L, amb):
    """Random codes (3% code 4 = ambiguous when amb), short lengths with
    zero-length padding rows and a full clean row, and ownership
    limits."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[3:][rng.random((B - 3, L)) < 0.03] = 4
    lengths = rng.integers(0, L + 1, B, dtype=np.int32)
    lengths[:2] = 0
    lengths[2] = L
    limits = rng.integers(1, L + 1, B, dtype=np.int32)
    limits[2] = L
    return codes, lengths, limits


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port_table(n_bases, r_len, hi, lo, counts):
    fused, cts = gapped_run_pairs(hi.numpy(), lo.numpy(), counts.numpy(),
                                  r_len, n_bases)
    return KmerTable.from_fused(n_bases, fused, cts)


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb,seg", [
    (5, 5, 12, 20, 40, False, 8),     # W=1 keys, c range partly > L
    (5, 3, 10, 14, 32, True, 2),      # asymmetric windows + ambiguity
    (27, 27, 54, 60, 80, False, 2),   # the reference's windows, W=4 keys
])
def test_plain_k3_equals_pallas_k3(llen, rlen, cmin, cmax, L, amb, seg):
    B, nb = 10, llen + rlen
    codes, lengths, limits = _batch(llen * 100 + cmin + amb, B, L, amb)
    rflat, jcounts = fused_gapped_count_T(
        jnp.asarray(codes).T, jnp.asarray(lengths), jnp.asarray(limits),
        l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax, mask_ambiguous=amb,
        seg=seg, block_lanes=128, algo="dedup", interpret=True)
    T = gapped_lane_count(L, cmin, cmax)
    T_pad = -(-T // seg) * seg
    jc = np.asarray(jcounts).reshape(T_pad, -1)[:, :B].T       # (B, T_pad)
    std = np.stack([np.asarray(w).reshape(T_pad, -1)[:, :B].T
                    for w in C.unpack_words(rflat, nb)], axis=-1)

    hi, lo, counts = fg.fused_gapped_count(
        *_t(codes, lengths, limits), l_len=llen, r_len=rlen, c_min=cmin,
        c_max=cmax, mask_ambiguous=amb, seg=seg)
    assert hi.shape == lo.shape == counts.shape == (B, T_pad)
    assert counts.dtype == torch.int8 and hi.dtype == torch.int64
    # the collapse: counts lane for lane; keys on every live lane
    np.testing.assert_array_equal(counts.numpy(), jc.astype(np.int8))
    live = jc > 0
    np.testing.assert_array_equal(
        tenc.pairs_to_u32(hi.numpy()[live], lo.numpy()[live], llen, rlen),
        std[live])
    # and the aggregated tables
    want = JaxTable.from_pairs(nb, std[live], jc[live])
    assert _port_table(nb, rlen, hi, lo, counts) == want
    assert want.total > 0
    if not amb:
        # 2-bit packed rows give the same lanes as u8 rows
        packed = torch.from_numpy(pack_batch_codes(codes).view(np.int32))
        got = fg.fused_gapped_count(
            packed, *_t(lengths, limits), l_len=llen, r_len=rlen,
            c_min=cmin, c_max=cmax, seg=seg, packed_width=L)
        assert all(torch.equal(a, b) for a, b in zip(got, (hi, lo, counts)))


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb", [
    (27, 27, 80, 84, 100, False),
    (13, 9, 30, 40, 36, True),        # c_max > L: a partial triangle
    (6, 4, 10, 12, 9, False),         # L < c_min: no lanes at all
    (31, 31, 62, 64, 70, True),       # 62 bases, both windows full
])
def test_gapped_lanes_lane_for_lane(llen, rlen, cmin, cmax, L, amb):
    B = 12
    codes, lengths, limits = _batch(L + amb, B, L, amb)
    words, valid = jax_gapped_lanes(
        jnp.asarray(codes), jnp.asarray(lengths), llen, rlen, c_min=cmin,
        c_max=cmax, limits=jnp.asarray(limits), mask_ambiguous=amb)
    want = np.stack([np.asarray(w) for w in words], axis=-1)  # (B, T, W)
    (hi, lo), v = gapped_lanes(*_t(codes, lengths), llen, rlen, cmin, cmax,
                               limits=torch.from_numpy(limits),
                               mask_ambiguous=amb)
    T = gapped_lane_count(L, cmin, cmax)
    assert hi.shape == lo.shape == v.shape == (B, T) == want.shape[:2]
    np.testing.assert_array_equal(v.numpy(), np.asarray(valid))
    got = tenc.pairs_to_u32(hi.numpy(), lo.numpy(), llen, rlen)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert T == 0 or v.any()


@pytest.mark.parametrize("llen,rlen", [(27, 27), (24, 23), (16, 16),
                                       (20, 11), (5, 3), (31, 31), (1, 31)])
def test_pair_words_roundtrip(llen, rlen):
    """(hi, lo) <-> (M, W) uint32 words for W = 1..4, against kmer_tpu's
    key words of the l+r bases; sentinel pairs <-> all-ones rows."""
    rng = np.random.default_rng(llen * 64 + rlen)
    n = llen + rlen
    codes = rng.integers(0, 4, (40, n), dtype=np.uint8)
    codes[0], codes[1] = 0, 3
    words = np.stack([key_words_from_codes(c) for c in codes])
    pw = lambda m: 4 ** np.arange(m - 1, -1, -1, dtype=np.int64)  # noqa: E731
    hi = codes[:, :llen].astype(np.int64) @ pw(llen)
    lo = codes[:, llen:].astype(np.int64) @ pw(rlen)
    sent = np.full(2, tenc.SENTINEL_KEY, np.int64)
    hi, lo = np.concatenate([hi, sent]), np.concatenate([lo, sent])
    words = np.concatenate([words, np.full((2, words.shape[1]), 0xFFFFFFFF,
                                           np.uint32)])
    assert words.shape[1] == tenc.words_per_key(n)
    np.testing.assert_array_equal(tenc.pairs_to_u32(hi, lo, llen, rlen),
                                  words)
    bh, bl = tenc.u32_to_pairs(words, llen, rlen)
    np.testing.assert_array_equal(bh, hi)
    np.testing.assert_array_equal(bl, lo)


def _words(codes):
    """(M, n) codes -> (M, W) key words, vectorised (the layout of
    kmer_tpu's key_words_from_codes)."""
    n = codes.shape[1]
    W = tenc.words_per_key(n)
    out = np.zeros((len(codes), W), np.uint32)
    for j in range(n):
        bit = 2 * (n - 1 - j)
        out[:, W - 1 - bit // 32] |= (codes[:, j].astype(np.uint32)
                                      << np.uint32(bit % 32))
    return out


def _wide_pairs(n_bases, n, seed):
    """n random (M, W) uint32 keys of n_bases bases, many repeated."""
    rng = np.random.default_rng(seed)
    distinct = rng.integers(0, 4, (max(n // 4, 1), n_bases), dtype=np.uint8)
    words = _words(distinct)
    np.testing.assert_array_equal(words[0], key_words_from_codes(distinct[0]))
    return words[rng.integers(0, len(distinct), n)], rng.integers(1, 9, n)


@pytest.mark.parametrize("n", [700, nativeagg.MIN_N + 321])
@pytest.mark.parametrize("n_bases", [40, 47, 54, 63])
def test_wide_tables_match(n_bases, n, tmp_path):
    """W = 3, 4 keys through from_pairs (numpy and native), .npz both
    ways, TSV bytes and the accumulator."""
    keys, counts = _wide_pairs(n_bases, n, n_bases + n)
    got = KmerTable.from_pairs(n_bases, keys, counts)
    want = JaxTable.from_pairs(n_bases, keys, counts)
    assert got == want and got.total == int(counts.sum())
    assert got.keys.shape[1] == tenc.words_per_key(n_bases) in (3, 4)
    got.save(str(tmp_path / "t.npz"))
    want.save(str(tmp_path / "j.npz"))
    assert KmerTable.load(str(tmp_path / "j.npz")) == want
    assert JaxTable.load(str(tmp_path / "t.npz")) == want
    a, b = io.StringIO(), io.StringIO()
    got.write_tsv(a)
    want.write_tsv(b)
    assert a.getvalue() == b.getvalue()
    ta, ja = (TableAccumulator(n_bases, flush_pairs=n // 3),
              JaxAccumulator(n_bases, flush_pairs=n // 3))
    for part in np.array_split(np.arange(n), 4):
        ta.add(KmerTable.from_pairs(n_bases, keys[part], counts[part]))
        ja.add(JaxTable.from_pairs(n_bases, keys[part], counts[part]))
    assert ta.result() == ja.result() == want


@pytest.mark.parametrize("n_bases,parts", [(54, 7), (54, 64), (21, 16),
                                           (8, 5), (47, 64)])
def test_route_partition_matches(n_bases, parts):
    rng = np.random.default_rng(n_bases + parts)
    words = _words(rng.integers(0, 4, (300, n_bases), dtype=np.uint8))
    got = route_partition(words, n_bases, parts)
    np.testing.assert_array_equal(got, jax_route(words, n_bases, parts))
    order = np.lexsort(words.T[::-1])
    assert np.all(np.diff(got[order]) >= 0) and got.max() < parts


def test_gapped_config_matches_reference():
    for kw in (dict(), dict(l_len=13, r_len=9, c_min=30, c_max=40,
                            max_read_len=64)):
        t, j = KmerConfig(gapped=True, **kw), JaxConfig(gapped=True, **kw)
        assert (t.n_bases, t.window_span, t.overlap) == (
            j.n_bases, j.window_span, j.overlap)
    assert KmerConfig(gapped=True, k=40).n_bases == 54
    for kw in (dict(mode="dense", k=8), dict(c_min=53), dict(l_len=0)):
        with pytest.raises(ValueError):
            KmerConfig(gapped=True, **kw)
        with pytest.raises(ValueError):
            JaxConfig(gapped=True, **kw)
    # windows over 31 bases configure as kmer_tpu's (ROADMAP item 15)
    wide = dict(gapped=True, l_len=32, r_len=27, c_min=80)
    assert (KmerConfig(**wide).n_bases, KmerConfig(**wide).window_span) == (
        JaxConfig(**wide).n_bases, JaxConfig(**wide).window_span)


def test_two_word_collapse():
    """Lanes are equal only when both words are; sentinels test hi."""
    S = tenc.SENTINEL_KEY
    hi = torch.tensor([[5, 5, 5, 5], [7, S, 7, 7]]).T.contiguous()
    lo = torch.tensor([[1, 2, 1, 1], [3, S, 3, 4]]).T.contiguous()
    assert dedup_runlen(hi, 4, lo).T.tolist() == [[3, 1, 0, 0],
                                                  [2, 0, 0, 1]]
    assert dedup_runlen(hi, 2, lo).T.tolist() == [[1, 1, 2, 0],
                                                  [1, 0, 1, 1]]


def test_k3_wrapper_edges():
    codes, lengths, limits = _batch(3, 4, 20, False)
    hi, lo, counts = fg.fused_gapped_count(
        *_t(codes, lengths, limits), l_len=6, r_len=4, c_min=21, c_max=30)
    assert hi.shape == lo.shape == counts.shape == (4, 0)
    with pytest.raises(ValueError, match="seg"):
        fg.fused_gapped_count(*_t(codes, lengths, limits), l_len=6,
                              r_len=4, c_min=10, c_max=12, seg=3)
    with pytest.raises(ValueError, match="unfused route"):
        fg.fused_gapped_count(*_t(codes, lengths, limits), l_len=32,
                              r_len=4, c_min=40, c_max=42)
    meta = torch.zeros((2, 30), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fg.fused_gapped_count(meta, lens, lens, l_len=6, r_len=4, c_min=10,
                              c_max=12)
