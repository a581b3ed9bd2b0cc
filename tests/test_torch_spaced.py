"""Spaced seeds (0/1 match masks, PatternHunter-style) in the port against
kmer_tpu, on the CPU, exactly (integer keys: tolerance zero); the port of
kmer_tpu's tests/test_spaced.py for what the port carries.

- parse_seed_mask, mask_from_positions and the palindrome check give
  kmer_tpu's answers;
- spaced_lanes equals kmer_tpu's string oracle (oracle_spaced_count) at
  one-word and (hi, lo) widths, canonical (palindromic masks) and with
  ambiguous bases at selected and at don't-care offsets;
- spaced K1's plain version equals kmer_tpu's interpret-mode
  fused_extract_count_T(positions=...) lane for lane, and spaced K7's
  plain version equals kmer_tpu's spaced_lanes words;
- count_fasta with split reads in the default, device-merge,
  sort_group_keys=0 and KMER_TPU_STEP=legacy modes equals the oracle and
  kmer_tpu.count_fasta;
- `count --seed-mask` and `card --seed-mask` write kmer_tpu's bytes;
- KmerConfig refuses what kmer_tpu refuses.
"""

import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops import extract as jext
from kmer_tpu.ops.pallas.fused_extract import fused_extract_count_T
from kmer_tpu.utils import oracle
import kmer_tpu_torch
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.ops import extract as text
from kmer_tpu_torch.ops.encode import (u32_to_pairs, keys_u32_to_i64,
                                       words_to_tpu_repacked)
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.pipeline.table import KmerTable

from test_torch_count import REPO

# chip_smoke.py's two masks: span 31 with 24 selected (one word) and span 55
# with 42 selected (a pair)
MASK24 = "1110111011101110111011101110111"
MASK42 = "1110111011101110111011101110111011101110111011101110111"
MASK63 = "1" * 31 + "0" * 5 + "1" * 32           # r_len = 32, not palindromic


def test_parse_seed_mask():
    for mask in ("1101011", MASK24, MASK42, "1", "11", "101"):
        assert text.parse_seed_mask(mask) == jext.parse_seed_mask(mask)
        assert (text.seed_mask_palindromic(mask)
                == jext.seed_mask_palindromic(mask))
        assert text.mask_from_positions(text.parse_seed_mask(mask)) == mask
    assert not text.seed_mask_palindromic("1101")
    for bad in ("", "102", "011", "110", "0"):
        with pytest.raises(ValueError):
            text.parse_seed_mask(bad)


def _codes(mask, amb, B=14, L=70):
    rng = np.random.default_rng(zlib.crc32(mask.encode()) + amb)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.03] = 4
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = L
    return codes, lengths


def _table(n_bases, keys, valid):
    """The valid lanes of port keys (int64 or (hi, lo)) as a KmerTable."""
    v = valid.numpy().reshape(-1)
    if isinstance(keys, tuple):
        from kmer_tpu_torch.ops.encode import pairs_to_u32
        words = pairs_to_u32(keys[0].numpy().reshape(-1)[v],
                             keys[1].numpy().reshape(-1)[v], 31,
                             n_bases - 31)
    else:
        from kmer_tpu_torch.ops.encode import keys_i64_to_u32
        words = keys_i64_to_u32(keys.numpy().reshape(-1)[v], n_bases)
    return KmerTable.from_pairs(n_bases, words, np.ones(int(v.sum()),
                                                        np.int64))


@pytest.mark.parametrize("mask,canon,amb", [
    ("1101011", False, False), ("1101011", True, False), ("11011", True, True),
    ("1" * 10 + "0" * 5 + "1" * 10, False, False),
    ("110100101011", False, True), (MASK24, True, True),
    (MASK42, True, False), (MASK42, False, True), (MASK63, False, False)])
def test_spaced_lanes_matches_oracle(mask, canon, amb):
    codes, lengths = _codes(mask, amb)
    keys, valid = text.spaced_lanes(torch.from_numpy(codes),
                                    torch.from_numpy(lengths), mask,
                                    mask_ambiguous=amb, canonical=canon)
    n = mask.count("1")
    got = _table(n, keys, valid)
    seqs = ["".join("ACGTN"[c] for c in row[:ln])
            for row, ln in zip(codes, lengths)]
    want = oracle.oracle_spaced_count(seqs, mask, canonical=canon,
                                      skip_invalid=True)
    assert got.to_dict() == dict(want) and got.total > 0


def test_spaced_lanes_refuse_non_palindromic_canonical():
    codes, lengths = _codes("1101", False)
    with pytest.raises(ValueError, match="palindromic"):
        text.spaced_lanes(torch.from_numpy(codes), torch.from_numpy(lengths),
                          "1101", canonical=True)
    with pytest.raises(ValueError, match="palindromic"):
        fe.fused_extract_count(torch.from_numpy(codes),
                               torch.from_numpy(lengths),
                               torch.from_numpy(lengths), 3,
                               positions=(0, 1, 3), canonical=True)


@pytest.mark.parametrize("mask,canon,amb", [
    ("1101011", True, False), ("11011", False, True),
    ("1" * 10 + "0" * 5 + "1" * 10, False, False), (MASK24, True, True),
    (MASK24, False, False), (MASK42, True, True), (MASK42, False, False),
    (MASK63, False, True)])
def test_spaced_k1_plain_equals_tpu_kernel(mask, canon, amb):
    """Lane for lane: kmer_tpu's spaced banded-matmul kernel in interpret
    mode, through the repacked converters (keys and seg = 2 counts)."""
    positions = text.parse_seed_mask(mask)
    n = len(positions)
    rng = np.random.default_rng(len(mask) * 7 + canon + amb)
    B, L = 128, 96
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.01] = 4
    codes[0] = 3
    lengths = rng.integers(len(mask), L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    words, counts = fused_extract_count_T(
        jnp.asarray(codes.T), jnp.asarray(lengths), jnp.asarray(limits), n,
        canonical=canon, mask_ambiguous=amb, seg=2, algo="dedup",
        positions=positions, interpret=True)
    keys, got_counts = fe.fused_extract_count(
        torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(limits), n, canonical=canon, mask_ambiguous=amb,
        seg=2, positions=positions)
    P_pad = got_counts.shape[0]
    want = [np.asarray(w).reshape(P_pad, -1)[:, :B] for w in words]
    got = words_to_tpu_repacked(
        tuple(k.numpy() for k in keys) if isinstance(keys, tuple)
        else keys.numpy(), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        got_counts.numpy(), np.asarray(counts).reshape(P_pad, -1)[:, :B])
    assert int((got_counts > 0).sum()) > 0


@pytest.mark.parametrize("mask,canon", [("1101011", True), (MASK24, False),
                                        (MASK42, True), (MASK63, False)])
def test_spaced_k7_plain_equals_tpu_lanes(mask, canon):
    codes, lengths = _codes(mask, True, B=30, L=90)
    limits = np.full(len(lengths), 40, np.int32)
    words, _ = jext.spaced_lanes(jnp.asarray(codes), jnp.asarray(lengths),
                                 mask, limits=jnp.asarray(limits),
                                 mask_ambiguous=True, canonical=canon)
    u32 = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    n = mask.count("1")
    want = (u32_to_pairs(u32, 31, n - 31) if n > 31
            else (keys_u32_to_i64(u32, n),))
    got = ek.extract_keys(torch.from_numpy(codes), torch.from_numpy(lengths),
                          torch.from_numpy(limits), n, canonical=canon,
                          mask_ambiguous=True,
                          positions=text.parse_seed_mask(mask))
    got = got if isinstance(got, tuple) else (got,)
    assert got[0].shape == (len(codes), 90 - len(mask) + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(-1), w)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("spaced") / "sp.fasta"
    path.write_text(genome_reads_fasta(60, 200, genome_len=3000, seed=21))
    return str(path)


@pytest.mark.parametrize("mode,env,extra", [
    ("default", {}, {}), ("device_merge", {}, dict(device_merge="on")),
    ("sort_group_keys=0", {}, dict(sort_group_keys=0)),
    ("legacy", dict(KMER_TPU_STEP="legacy"), {})])
@pytest.mark.parametrize("mask,canon", [("110101011", True),
                                        (MASK42, True), (MASK63, False)])
def test_spaced_count_end_to_end(corpus, monkeypatch, mask, canon, mode, env,
                                 extra):
    """count_fasta with seed_mask over split reads (200-base reads in
    96-base rows) and packed transfer: the string oracle's table, and
    kmer_tpu's."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    kw = dict(seed_mask=mask, canonical=canon, batch_reads=16,
              max_read_len=96, sort_group_keys=64)
    cfg = KmerConfig(**{**kw, **extra})
    got = kmer_tpu_torch.count_fasta(corpus, cfg, device="cpu")
    want = oracle.oracle_spaced_count(oracle.read_fasta_py(corpus), mask,
                                      canonical=canon)
    assert got.to_dict() == dict(want)
    assert got.total == 60 * (200 - len(mask) + 1)
    if mode == "default":
        assert got == kmer_tpu.count_fasta(corpus, kmer_tpu.KmerConfig(**kw))


@pytest.mark.parametrize("extra", [["--seed-mask", "110011"],
                                   ["--seed-mask", MASK42, "--canonical"]])
def test_spaced_cli_count_bytes(corpus, capsys, extra):
    args = ["count", corpus, *extra, "--batch-reads", "8",
            "--max-read-len", "64"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    res = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == want and want.count("\n") > 100
    from kmer_tpu_torch.cli import main
    assert main(["count", corpus, "--seed-mask", "1101", "--canonical",
                 "--device", "cpu"]) == 1
    assert "palindromic" in capsys.readouterr().err
    assert main(["count", corpus, "--seed-mask", "11", "--gapped",
                 "--device", "cpu"]) == 1


@pytest.mark.parametrize("extra", [["--seed-mask", "11011"],
                                   ["--seed-mask", MASK42, "--canonical"]])
def test_spaced_cli_card_bytes(corpus, capsys, extra):
    args = ["card", corpus, *extra, "--batch-reads", "16",
            "--max-read-len", "96"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    res = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == want and "distinct_estimate" in want


@pytest.mark.parametrize("kw,match", [
    (dict(seed_mask="11011", compact=True), "compact"),
    (dict(seed_mask="11011", gapped=True), "exclusive"),
    (dict(seed_mask="11011", mode="dense", k=8), "sort mode"),
    (dict(seed_mask="1101", canonical=True), "palindromic"),
    (dict(seed_mask="1" * 64), "more than 63"),
    (dict(seed_mask="1" * 30 + "0" * 300 + "1"), "max_read_len"),
    (dict(seed_mask="0110"), "start and end")])
def test_config_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        KmerConfig(**kw)
    with pytest.raises(ValueError):
        kmer_tpu.KmerConfig(**kw)


def test_config_widths():
    for mask in ("11011", MASK24, MASK42, MASK63):
        t, j = KmerConfig(seed_mask=mask), kmer_tpu.KmerConfig(seed_mask=mask)
        assert (t.n_bases, t.window_span, t.overlap, t.effective_mode) == (
            j.n_bases, j.window_span, j.overlap, j.effective_mode)
        assert t.seed_positions == jext.parse_seed_mask(mask)
