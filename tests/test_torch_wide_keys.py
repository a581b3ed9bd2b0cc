"""Keys of any width (ROADMAP item 18): the port's W-word int64 layout
against kmer_tpu, on the CPU, exactly (integer keys: tolerance zero).

- ops/encode's W-word layout (words64, word_bases) converts to and from
  kmer_tpu's (M, W32) uint32 words at every width class, the 32-base
  last word's flipped top bit included;
- the plain kmer_lanes and canonical_kmer_lanes equal kmer_tpu's at k =
  64 to 125, with ambiguous codes and short rows, as the multiset of
  valid keys;
- count_fasta(..., device="cpu") tables equal kmer_tpu.count_fasta's at
  k = 64, 101 and 111 on every sort-mode route, and at
  test_very_wide_keys_k101's configuration (also against the string
  oracle); k = 112 with compact raises as in kmer_tpu;
- the table layer past two fused columns (np.lexsort), `count -k 101`
  bytes, and `dump` / `query` on a saved k = 101 table.

Streaming, `card` and the mesh at these widths are held against
kmer_tpu in test_torch_wide_paths.py.

kmer_tpu is imported only as the reference; inputs are made from seeds
with numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops import encode as jenc
from kmer_tpu.ops.canonical import canonical_kmer_lanes as jax_canonical
from kmer_tpu.ops.extract import kmer_lanes as jax_kmer_lanes
from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu.utils import oracle
import kmer_tpu_torch
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.cli import main
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.ops.canonical import canonical_kmer_lanes
from kmer_tpu_torch.ops.extract import kmer_lanes
from kmer_tpu_torch.pipeline.table import (KmerTable, fuse_words,
                                           reduce_fused, unfuse_words)

WIDTHS = [32, 63, 64, 94, 95, 101, 111, 125, 126, 160]
# (environment, config) of each sort-mode route
ROUTES = {
    "default": ({}, {}),
    "compact": ({}, dict(compact=True)),
    "device_merge": ({}, dict(device_merge="on")),
    "sort_group_keys=0": ({}, dict(sort_group_keys=0)),
    "legacy": (dict(KMER_TPU_STEP="legacy"), {}),
    "t": (dict(KMER_TPU_STEP="t"), {}),
    "grouped_pallas": (dict(KMER_TPU_STEP="legacy",
                            KMER_TPU_GROUPED="pallas"), {}),
}
SMALL = dict(batch_reads=16, max_read_len=160, sort_group_keys=64)


def _codes_words(rng, M: int, n: int):
    """(M, n) codes with the all-T and all-A rows, and kmer_tpu's words."""
    codes = rng.integers(0, 4, (M, n), dtype=np.uint8)
    codes[0], codes[1] = 3, 0
    return codes, np.stack([jenc.key_words_from_codes(c) for c in codes])


def _planes_from_codes(codes: np.ndarray) -> list[np.ndarray]:
    """The general layout built independently: 31 bases a word, the rest
    in the last; a 32-base word's top bit flipped."""
    n = codes.shape[1]
    out, q = [], 0
    for b in tenc.word_bases(n):
        v = np.zeros(len(codes), np.uint64)
        for j in range(q, q + b):
            v = (v << np.uint64(2)) | codes[:, j].astype(np.uint64)
        if b == 32:
            v ^= np.uint64(1 << 63)
        out.append(v.view(np.int64))
        q += b
    return out


@pytest.mark.parametrize("n", WIDTHS)
def test_layout_round_trips_kmer_tpu_words(n):
    rng = np.random.default_rng(n)
    codes, words = _codes_words(rng, 200, n)
    bases = tenc.word_bases(n)
    assert sum(bases) == n and len(bases) == tenc.words64(n)
    assert all(b == 31 for b in bases[:-1]) and 1 <= bases[-1] <= 32
    planes = tenc.u32_to_planes(words, bases)
    for got, want in zip(planes, _planes_from_codes(codes)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tenc.planes_to_u32(planes, bases), words)
    # the table layer's fused columns, and sentinel rows
    fused = fuse_words(words, n)
    assert fused.ndim == 1 or fused.shape[1] == tenc.fused_columns(n)
    np.testing.assert_array_equal(unfuse_words(fused, n), words)
    sent = [np.full(3, tenc.SENTINEL_KEY, np.int64) for _ in bases]
    assert (tenc.planes_to_u32(sent, bases) == tenc.SENTINEL_WORD).all()
    back = tenc.u32_to_planes(tenc.planes_to_u32(sent, bases), bases)
    assert all((p == tenc.SENTINEL_KEY).all() for p in back)
    np.testing.assert_array_equal(tenc.codes_from_key_words(words, n), codes)


def test_word_order_is_key_order():
    """Lexicographic signed order over the words equals the order of the
    keys' strings, the flipped 32-base last word included (k = 94)."""
    rng = np.random.default_rng(5)
    codes, words = _codes_words(rng, 500, 94)
    planes = tenc.u32_to_planes(words, tenc.word_bases(94))
    by_planes = np.lexsort(planes[::-1])
    by_strings = np.argsort([r.tobytes() for r in codes], kind="stable")
    np.testing.assert_array_equal(codes[by_planes], codes[by_strings])


def _multiset(words: np.ndarray) -> list:
    return sorted(map(tuple, words.tolist()))


@pytest.mark.parametrize("k", [64, 95, 101, 125])
@pytest.mark.parametrize("canon", [False, True])
def test_plain_lanes_equal_kmer_tpu(k, canon):
    rng = np.random.default_rng(k + canon)
    B, L = 9, 190
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.004] = 4
    codes[0] = 3                                    # the all-T row
    lengths = rng.integers(k - 2, L + 1, B).astype(np.int32)
    lengths[1] = k - 1                              # a row too short
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    jfn = jax_canonical if canon else jax_kmer_lanes
    jw, jv = jfn(jnp.asarray(codes), jnp.asarray(lengths), k,
                 limits=jnp.asarray(limits), mask_ambiguous=True)
    jv = np.asarray(jv)
    want = np.stack([np.asarray(w)[jv] for w in jw], axis=1)
    tfn = canonical_kmer_lanes if canon else kmer_lanes
    keys, tv = tfn(torch.from_numpy(codes), torch.from_numpy(lengths), k,
                   limits=torch.from_numpy(limits), mask_ambiguous=True)
    tv = tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert len(keys) == tenc.words64(k)
    got = tenc.planes_to_u32([p.numpy()[tv] for p in keys],
                             tenc.word_bases(k))
    assert _multiset(got) == _multiset(want) and len(want) > 100
    assert all((p.numpy()[~tv] == tenc.SENTINEL_KEY).all() for p in keys)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("wide") / "g.fasta"
    path.write_text(genome_reads_fasta(40, 150, genome_len=1500, seed=12,
                                       error_rate=0.02))
    return str(path)


@pytest.fixture(scope="module")
def jax_tables(corpus):
    """kmer_tpu's canonical table at each width (each compiles once)."""
    return {k: kmer_tpu.count_fasta(corpus, kmer_tpu.KmerConfig(
        k=k, canonical=True, **SMALL)) for k in (64, 101, 111)}


@pytest.mark.parametrize("k", [64, 101, 111])
@pytest.mark.parametrize("route", list(ROUTES))
def test_count_equals_kmer_tpu(corpus, jax_tables, monkeypatch, k, route):
    env, extra = ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = kmer_tpu_torch.count_fasta(corpus, KmerConfig(
        k=k, canonical=True, **{**SMALL, **extra}), device="cpu")
    want = jax_tables[k]
    assert got == want and got.total == 40 * (150 - k + 1)
    assert got.keys.shape[1] == tenc.words_per_key(k)


def test_very_wide_keys_k101(tmp_path):
    """kmer_tpu's test_very_wide_keys_k101 configuration: exact against
    the string oracle and kmer_tpu, plain and compact."""
    p = tmp_path / "wide.fasta"
    p.write_text(genome_reads_fasta(20, 150, genome_len=2000, seed=41))
    cfg = KmerConfig(k=101, canonical=True, batch_reads=8,
                     max_read_len=128, sort_group_keys=64)
    got = kmer_tpu_torch.count_fasta(str(p), cfg, device="cpu")
    want = oracle.oracle_count(oracle.read_fasta_py(str(p)), 101,
                               canonical=True)
    assert got.to_dict() == dict(want)
    assert got == kmer_tpu.count_fasta(str(p), kmer_tpu.KmerConfig(
        k=101, canonical=True, batch_reads=8, max_read_len=128,
        sort_group_keys=64))
    assert kmer_tpu_torch.count_fasta(str(p), cfg.replace(compact=True),
                                      device="cpu") == got


def test_compact_caps_at_111_bases():
    KmerConfig(k=111, compact=True)
    with pytest.raises(ValueError, match="key words") as t:
        KmerConfig(k=112, compact=True)
    with pytest.raises(ValueError, match="key words") as j:
        kmer_tpu.KmerConfig(k=112, compact=True)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("n", [64, 101, 160])
def test_table_layer_past_two_columns(n):
    """from_pairs and reduce_fused over three to five fused columns (one
    np.lexsort) equal kmer_tpu's from_pairs, duplicates summed."""
    rng = np.random.default_rng(n)
    codes, words = _codes_words(rng, 300, n)
    words = np.concatenate([words, words[:100], words[50:60]])
    counts = rng.integers(1, 9, len(words))
    got = KmerTable.from_pairs(n, words, counts)
    assert got == JaxTable.from_pairs(n, words, counts)
    assert got.num_distinct == 300
    fused, summed = reduce_fused(fuse_words(words, n), counts)
    assert fused.shape == (300, tenc.fused_columns(n))
    np.testing.assert_array_equal(unfuse_words(fused, n), got.keys)
    np.testing.assert_array_equal(summed, got.counts)


def test_cli_count_k101_bytes(corpus, capsys):
    args = ["count", corpus, "-k", "101", "--canonical", "--batch-reads",
            "16", "--max-read-len", "160"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.count("\n") > 500


def test_dump_and_query_k101(corpus, tmp_path, capsys):
    """`dump` and `query` read a saved k = 101 table as kmer_tpu's do."""
    npz = str(tmp_path / "k101.npz")
    assert main(["count", corpus, "-k", "101", "--canonical",
                 "--batch-reads", "16", "--max-read-len", "160",
                 "--out-npz", npz, "--device", "cpu"]) == 0
    capsys.readouterr()
    table = KmerTable.load(npz)
    assert table == JaxTable.load(npz) and table.k == 101
    kmers = table.kmers()[:3] + ["A" * 101]
    for args in (["dump", npz], ["dump", npz, "--top", "5"],
                 ["dump", npz, "--histo"], ["query", npz, *kmers],
                 ["query", npz, "--canonical", *kmers]):
        assert jax_main(args) == 0
        want = capsys.readouterr().out
        assert main(args) == 0
        assert capsys.readouterr().out == want and want
