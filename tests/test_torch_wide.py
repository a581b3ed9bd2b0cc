"""Keys of 32 to 63 bases: the port's (hi, lo) int64 pairs against
kmer_tpu, on the CPU, exactly (integer keys: tolerance zero).

- ops/encode's converters carry kmer_tpu's repacked W = 3 and W = 4
  words (the s == 0 widths 32 and 48 included) and its table words to
  the port's pairs and back, k = 63's flipped lo included;
- K1's plain version (ops/kernels/fused_extract) equals kmer_tpu's
  interpret-mode fused_extract_count_T (the banded-matmul extraction,
  dedup collapse at seg = 2) lane for lane, keys and counts, and K7's
  plain version (ops/kernels/extract) equals that kernel's keys and
  kmer_tpu's kmer_lanes / canonical_kmer_lanes words, with ambiguous
  bases;
- count_fasta(..., device="cpu") tables equal kmer_tpu.count_fasta's at
  k = 33 and 63, canonical on and off, in sort, compact, device-merge
  (also draining) and both unfused modes, and the string oracle's at
  k = 32, 45, 48 and 62;
- the k = 63 sentinel trap: a poly-T key (hi = 2**62 - 1, stored lo =
  INT64_MAX) and a key ending in 32 T's are counted in every mode;
- `card -k 45` gives kmer_tpu's HyperLogLog classes, estimate and total.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kmer_tpu
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops import sketch as jsketch
from kmer_tpu.ops.canonical import canonical_kmer_lanes as jax_canonical
from kmer_tpu.ops.encode import key_words_from_codes
from kmer_tpu.ops.extract import kmer_lanes as jax_kmer_lanes
from kmer_tpu.ops.pallas.fused_extract import fused_extract_count_T
from kmer_tpu.pipeline.sketch import (estimate_distinct_multi_k as
                                      jax_estimate)
from kmer_tpu.utils.oracle import oracle_count, read_fasta_py
import kmer_tpu_torch
from kmer_tpu_torch.io.fasta import parse_seqs
from kmer_tpu_torch.ops.canonical import canonical_kmer_lanes
from kmer_tpu_torch.ops import sketch as tsketch
from kmer_tpu_torch.ops.encode import (LO_FLIP, SENTINEL_KEY, pairs_to_u32,
                                       u32_to_pairs, words_from_tpu_repacked,
                                       words_to_tpu_repacked)
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.pipeline.sketch import (estimate_distinct_multi_k,
                                            sketch_histograms)

WIDE_K = [32, 33, 45, 48, 62, 63]
SMALL = dict(batch_reads=64, max_read_len=96)     # split reads, 5+ batches
# (environment, config) of each route a wide key takes
MODES = {
    "sort": ({}, {}),
    "compact": ({}, dict(compact=True)),
    "device_merge": ({}, dict(device_merge="on")),
    "device_merge_drain": (dict(KMER_TPU_DEVMERGE_ROWS="4096"),
                           dict(device_merge="on")),
    "legacy": (dict(KMER_TPU_STEP="legacy"), {}),
    "sort_group_keys=0": ({}, dict(sort_group_keys=0)),
}


def _batch(rng, B, L, amb_share=0.02):
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < amb_share] = 4
    codes[0] = 3                                  # poly-T rows
    codes[1, 40:] = 3
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:2] = L
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    limits[:2] = L
    return codes, lengths, limits


def _np(keys):
    return (tuple(k.numpy() for k in keys) if isinstance(keys, tuple)
            else keys.numpy())


@pytest.mark.parametrize("k", WIDE_K)
def test_repacked_and_table_words_roundtrip(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (40, k), dtype=np.uint8)
    codes[0], codes[1] = 3, 0
    codes[2, -32:] = 3                 # a lo of all T's (k = 63: 64 bits)
    words = np.stack([key_words_from_codes(c) for c in codes])
    words = np.concatenate([words, np.full((2, words.shape[1]), 0xFFFFFFFF,
                                           np.uint32)])
    hi, lo = u32_to_pairs(words, 31, k - 31)
    value = [int("".join(map(str, c)), 4) for c in codes]
    r = 2 * (k - 31)
    flip = (1 << 63) if r == 64 else 0
    assert [int(h) for h in hi[:40]] == [v >> r for v in value]
    assert [int(v) & ((1 << 64) - 1) for v in lo[:40]] == [
        (v & ((1 << r) - 1)) ^ flip for v in value]
    assert (hi[40:] == SENTINEL_KEY).all() and (lo[40:] == SENTINEL_KEY).all()
    np.testing.assert_array_equal(pairs_to_u32(hi, lo, 31, k - 31), words)
    rw = words_to_tpu_repacked((hi, lo), k)
    assert len(rw) == words.shape[1] and all(w.dtype == np.uint32 for w in rw)
    back = words_from_tpu_repacked(rw, k)
    np.testing.assert_array_equal(back[0], hi)
    np.testing.assert_array_equal(back[1], lo)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", WIDE_K)
def test_k1_plain_equals_tpu_kernel(k, canonical):
    """Lane for lane through the repacked converters: keys, sentinels and
    the seg = 2 counts, with ambiguous bases, short rows and limits."""
    rng = np.random.default_rng(100 + k + canonical)
    B, L = 128, 96
    codes, lengths, limits = _batch(rng, B, L)
    words, counts = fused_extract_count_T(
        jnp.asarray(codes.T), jnp.asarray(lengths), jnp.asarray(limits), k,
        canonical=canonical, mask_ambiguous=True, seg=2, algo="dedup",
        extract="mxu", interpret=True)
    keys, got_counts = fe.fused_extract_count(
        torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(limits), k, canonical=canonical,
        mask_ambiguous=True, seg=2)
    P_pad = got_counts.shape[0]
    want = [np.asarray(w).reshape(P_pad, -1)[:, :B] for w in words]
    got = words_to_tpu_repacked(_np(keys), k)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got_counts.numpy(), np.asarray(counts).reshape(P_pad, -1)[:, :B])
    back = words_from_tpu_repacked(want, k)
    np.testing.assert_array_equal(back[0], keys[0].numpy())
    np.testing.assert_array_equal(back[1], keys[1].numpy())
    assert int((got_counts > 0).sum()) > 0
    # K7's plain version: the same keys before the collapse, row-major
    keys7 = ek.extract_keys(torch.from_numpy(codes),
                            torch.from_numpy(lengths),
                            torch.from_numpy(limits), k, canonical=canonical,
                            mask_ambiguous=True)
    P = L - k + 1
    for g, w in zip(words_to_tpu_repacked(tuple(p.numpy().T for p in keys7),
                                          k), want):
        np.testing.assert_array_equal(g, w[:P])


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", WIDE_K)
def test_k7_plain_equals_tpu_lanes(k, canonical):
    """K7's plain version against kmer_tpu's extraction of the unfused
    route (kmer_lanes / canonical_kmer_lanes: kmer_tpu's K7 kernel takes
    only 17 <= k <= 31), packed and u8 rows."""
    rng = np.random.default_rng(200 + k + canonical)
    B, L = 40, 90
    codes, lengths, limits = _batch(rng, B, L)
    fn = jax_canonical if canonical else jax_kmer_lanes
    words, _ = fn(jnp.asarray(codes), jnp.asarray(lengths), k,
                  limits=jnp.asarray(limits), mask_ambiguous=True)
    want = u32_to_pairs(np.stack([np.asarray(w).reshape(-1) for w in words],
                                 1), 31, k - 31)
    got = ek.extract_keys(torch.from_numpy(codes), torch.from_numpy(lengths),
                          torch.from_numpy(limits), k, canonical=canonical,
                          mask_ambiguous=True)
    assert isinstance(got, tuple) and got[0].shape == (B, L - k + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(-1), w)
    # packed rows (no ambiguity code) give the same keys as u8 rows
    from kmer_tpu_torch.io.fasta import pack_batch_codes
    clean = codes & 3
    packed = torch.from_numpy(pack_batch_codes(clean).view(np.int32))
    args = (torch.from_numpy(lengths), torch.from_numpy(limits), k)
    a = ek.extract_keys(packed, *args, canonical=canonical, packed_width=L)
    b = ek.extract_keys(torch.from_numpy(clean), *args, canonical=canonical)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("wide") / "genome.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=4,
                                       error_rate=0.01))
    return str(path)


@pytest.fixture(scope="module")
def jax_tables(corpus):
    cache = {}

    def get(k, canonical):
        if (k, canonical) not in cache:
            cache[k, canonical] = kmer_tpu.count_fasta(
                corpus, k=k, canonical=canonical, **SMALL)
        return cache[k, canonical]
    return get


def _count(corpus, monkeypatch, mode, **kw):
    env, extra = MODES[mode]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return kmer_tpu_torch.count_fasta(corpus, device="cpu", **SMALL, **kw,
                                      **extra)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [33, 63])
def test_count_equals_kmer_tpu(corpus, jax_tables, monkeypatch, k,
                               canonical, mode):
    got = _count(corpus, monkeypatch, mode, k=k, canonical=canonical)
    want = jax_tables(k, canonical)
    assert got == want and got.total == 300 * (150 - k + 1)
    assert got.keys.shape[1] == (4 if k == 63 else 3)


@pytest.fixture(scope="module")
def oracle_tables(corpus):
    cache = {}
    seqs = read_fasta_py(corpus)

    def get(k, canonical):
        if (k, canonical) not in cache:
            cache[k, canonical] = dict(oracle_count(seqs, k, canonical))
        return cache[k, canonical]
    return get


@pytest.mark.parametrize("mode", ["sort", "compact", "device_merge",
                                  "legacy", "sort_group_keys=0"])
@pytest.mark.parametrize("k,canonical", [(32, True), (45, False),
                                         (48, True), (62, False)])
def test_count_equals_oracle(corpus, oracle_tables, monkeypatch, k,
                             canonical, mode):
    got = _count(corpus, monkeypatch, mode, k=k, canonical=canonical)
    assert got.to_dict() == oracle_tables(k, canonical)


@pytest.mark.parametrize("mode", list(MODES))
def test_k63_sentinel_trap(tmp_path, monkeypatch, mode):
    """Non-canonical k = 63: the poly-T key's stored words are (2**62 -
    1, INT64_MAX) and a real hi with 32 T's gives lo = INT64_MAX too;
    neither may be taken for the sentinel (INT64_MAX in hi)."""
    head = "ACGTTGCAACGTTGCAACGTTGCAACGTTGC"               # 31 bases
    path = tmp_path / "t.fasta"
    path.write_text(f">a\n{'T' * 70}\n>b\n{head}{'T' * 32}\n"
                    f">c\nACGT{'T' * 62}\n")
    got = _count(str(path), monkeypatch, mode, k=63)
    assert got.to_dict() == {"T" * 63: 8 + 1, head + "T" * 32: 1,
                             "ACGT" + "T" * 59: 1, "CGT" + "T" * 60: 1,
                             "GT" + "T" * 61: 1}
    keys, _ = fe.fused_extract_count(
        torch.full((1, 64), 3, dtype=torch.uint8),
        torch.tensor([64], dtype=torch.int32),
        torch.tensor([64], dtype=torch.int32), 63)
    assert keys[0][0, 0] == (1 << 62) - 1 and keys[1][0, 0] == SENTINEL_KEY
    assert int(keys[1][0, 0]) ^ LO_FLIP == -1     # the raw lo: 64 T bits


def test_card_k45_equals_kmer_tpu(corpus):
    """`card -k 45 --canonical`: the class histogram of kmer_tpu's
    hll_classes over its own keys, and kmer_tpu's estimate and total."""
    cfg = kmer_tpu_torch.KmerConfig(k=45, canonical=True, batch_reads=64,
                                    max_read_len=256)
    hists, totals = sketch_histograms(corpus, [45], cfg, device="cpu")
    codes, offsets = parse_seqs(corpus)
    lens = np.diff(offsets).astype(np.int32)
    rows = np.zeros((len(lens), int(lens.max())), np.uint8)
    for i, (a, n) in enumerate(zip(offsets[:-1], lens)):
        rows[i, :n] = codes[a:a + n]
    words, valid = jax_canonical(jnp.asarray(rows), jnp.asarray(lens), 45)
    cls, _ = jsketch.hll_classes([np.asarray(w).reshape(-1) for w in words],
                                 None, 10)
    v = np.asarray(valid).reshape(-1)
    want = np.bincount(np.asarray(cls)[v], minlength=1 << 15)
    np.testing.assert_array_equal(hists[45], want)
    assert totals[45] == int(v.sum()) == 300 * 106
    [(est, total)] = estimate_distinct_multi_k(corpus, [45], cfg,
                                               device="cpu")
    [(jest, jtotal)] = jax_estimate(corpus, [45], kmer_tpu.KmerConfig(
        k=45, canonical=True, batch_reads=64, max_read_len=256))
    assert (est, total) == (jest, jtotal)
    # the port's hash of the pair layout is kmer_tpu's on the same keys
    keys, _ = canonical_kmer_lanes(torch.from_numpy(rows),
                                   torch.from_numpy(lens), 45)
    live = torch.from_numpy(v.copy())
    got = tsketch.hll_classes(tuple(p.reshape(-1)[live] for p in keys), 45,
                              10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(cls)[v])


@pytest.mark.parametrize("k,canonical,extra", [
    (33, True, {}), (63, False, dict(device_merge="on")),
    (45, True, dict(compact=True))])
def test_skip_invalid_equals_kmer_tpu(tmp_path, k, canonical, extra):
    """N and IUPAC bases drop every window that holds one, at two words
    (u8 rows with the ambiguity code instead of packed rows)."""
    rng = np.random.default_rng(k)
    seqs = rng.choice(list("ACGTN"), size=(40, 170),
                      p=[.2475, .2475, .2475, .2475, .01])
    path = tmp_path / "n.fasta"
    path.write_text("".join(f">r{i}\n{''.join(s)}\n"
                            for i, s in enumerate(seqs)))
    kw = dict(k=k, canonical=canonical, skip_invalid=True, **SMALL)
    got = kmer_tpu_torch.count_fasta(str(path), device="cpu", **kw, **extra)
    assert got == kmer_tpu.count_fasta(str(path), **kw) and got.total > 0
