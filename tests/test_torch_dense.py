"""The index histogram (kernel K5), dense mode and the HyperLogLog `card`
path against kmer_tpu, exactly (integer histograms and tables:
tolerance zero; estimates compared as the same floats), on inputs from
np.random.default_rng:

- index_histogram_ref against kmer_tpu's Pallas K5 in interpret mode,
  through histogram_from_tpu;
- the port's HLL classes against kmer_tpu.ops.sketch.hll_classes on its
  numpy oracle path, and the port's hll_step histogram against
  kmer_tpu's hll_step;
- dense tables (K5 for k <= 8, the host hybrid for k = 9..12 and its
  device scatter branch), estimate_distinct_multi_k and the `card` CLI
  against kmer_tpu.
The CUDA kernel is held against the plain version in test_torch_cuda.py.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops import sketch as jsketch
from kmer_tpu.ops.pallas.histogram import index_histogram_mxu
from kmer_tpu.pipeline.sketch import \
    estimate_distinct_multi_k as jax_estimate
import kmer_tpu_torch
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops import sketch
from kmer_tpu_torch.ops.encode import keys_i64_to_u32
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.ops.kernels import histogram as hk
from kmer_tpu_torch.pipeline.count import (count_step_dense,
                                           count_step_scatter)

from test_torch_count import REPO, SMALL


@pytest.mark.parametrize("bits,N", [(1, 3000), (8, 5000), (15, 4096),
                                    (16, 6000)])
def test_k5_plain_equals_pallas_histogram(bits, N):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, N)
    valid = rng.random(N) < 0.8              # an invalid share
    want = index_histogram_mxu(jnp.asarray(idx, jnp.int32),
                               jnp.asarray(valid), bits, interpret=True)
    got = hk.index_histogram(torch.from_numpy(idx),
                             torch.from_numpy(valid.astype(np.int8)), bits)
    assert got.dtype == torch.int64 and got.shape == (1 << bits,)
    np.testing.assert_array_equal(got.numpy(), hk.histogram_from_tpu(want))
    assert int(got.sum()) == int(valid.sum())


def test_k5_empty_weights_range_and_int64():
    """An empty stream gives zeros (kmer_tpu's ADVICE r1 case); weights
    add as counts; out-of-range indices drop; bins pass 2**31."""
    want = index_histogram_mxu(jnp.zeros((0,), jnp.int32),
                               jnp.zeros((0,), bool), 8, interpret=True)
    got = hk.index_histogram(torch.zeros(0, dtype=torch.int64),
                             torch.zeros(0, dtype=torch.int8), 8)
    np.testing.assert_array_equal(got.numpy(), hk.histogram_from_tpu(want))
    idx = torch.tensor([3, 3, 7, 300, -1, fe.SENTINEL_KEY])
    w = torch.tensor([2, 5, 1, 4, 4, 0], dtype=torch.int8)
    out = torch.zeros(256, dtype=torch.int64)
    out[3] = (1 << 31) - 3
    hk.index_histogram(idx, w, 8, out=out)
    assert out[3] == (1 << 31) + 4 and out[7] == 1 and int(out.sum()) == (
        (1 << 31) + 5)
    with pytest.raises(ValueError, match="bits"):
        hk.index_histogram(idx, w, 17)
    with pytest.raises(ValueError, match="meta"):
        hk.index_histogram(idx.to("meta"), w.to("meta"), 8)


def _k1_batch(seed, k, canonical, B=24, L=61):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B, dtype=np.int32)
    lengths[0] = L
    limits = rng.integers(1, L + 1, B, dtype=np.int32)
    keys, counts = fe.fused_extract_count(
        *map(torch.from_numpy, (codes, lengths, limits)), k,
        canonical=canonical)
    return (codes, lengths, limits), keys, counts


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [5, 15, 16, 21, 31])
def test_hll_classes_equal_kmer_tpu_oracle(k, canonical):
    _, keys, counts = _k1_batch(k + canonical, k, canonical)
    live = keys.reshape(-1)[counts.reshape(-1) > 0]
    words = keys_i64_to_u32(live.numpy(), k)
    for b in (4, 10, 11):
        want, _ = jsketch.hll_classes([words[:, j] for j in
                                       range(words.shape[1])],
                                      np.ones(len(words), bool), b)
        got = sketch.hll_classes(live, k, b)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hash_pieces_wrap_like_uint32():
    rng = np.random.default_rng(5)
    h = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    np.testing.assert_array_equal(
        sketch._mix32(torch.from_numpy(h.astype(np.int64))).numpy(),
        jsketch._mix32(h, True).astype(np.int64))
    for width in (21, 31):
        tail = h & np.uint32((1 << width) - 1)
        np.testing.assert_array_equal(
            sketch._rho32(torch.from_numpy(tail.astype(np.int64)),
                          width).numpy(),
            jsketch._rho32(tail, width, True).astype(np.int64))


@pytest.mark.parametrize("k,canonical,packed", [(21, True, True),
                                                (11, False, False)])
def test_hll_step_equals_kmer_tpu(k, canonical, packed):
    (codes, lengths, limits), _, _ = _k1_batch(40 + k, k, canonical, B=32,
                                               L=64)
    b = 8
    jhist = jsketch.hll_step(jnp.asarray(codes), jnp.asarray(lengths),
                             jnp.asarray(limits),
                             jnp.zeros(1 << (b + 5), jnp.int32), k=k,
                             canonical=canonical, b=b)
    c = pack_batch_codes(codes).view(np.int32) if packed else codes
    hist = torch.zeros(1 << (b + 5), dtype=torch.int64)
    got = sketch.hll_step(torch.from_numpy(np.ascontiguousarray(c)),
                          torch.from_numpy(lengths),
                          torch.from_numpy(limits), hist, k=k,
                          canonical=canonical, b=b,
                          packed_width=64 if packed else 0)
    assert got is hist
    np.testing.assert_array_equal(got.numpy(), hk.histogram_from_tpu(jhist))
    # the K5 wrapper's plain HLL path is the same histogram
    _, keys, counts = _k1_batch(40 + k, k, canonical, B=32, L=64)
    np.testing.assert_array_equal(
        hk.hll_class_histogram(keys, counts, k=k, b=b).numpy(), got.numpy())


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    p = tmp_path_factory.mktemp("dense") / "genome.fasta"
    p.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=21,
                                    error_rate=0.01))
    return str(p)


@pytest.mark.parametrize("k,canonical", [(1, False), (4, True), (8, False),
                                         (8, True), (9, True), (12, False)])
def test_dense_tables_equal_kmer_tpu(genome, k, canonical):
    want = kmer_tpu.count_fasta(genome, k=k, canonical=canonical,
                                mode="dense", **SMALL)
    got = kmer_tpu_torch.count_fasta(genome, k=k, canonical=canonical,
                                     mode="dense", device="cpu", **SMALL)
    assert got == want
    assert got.total == 300 * (150 - k + 1)
    assert kmer_tpu_torch.count_fasta(genome, k=k, canonical=canonical,
                                      mode="sort", device="cpu",
                                      **SMALL) == got


def test_dense_config_and_unported_scatter(genome, monkeypatch):
    """The dense scatter branch (ported now): KMER_TPU_DENSE_SCATTER=1
    gives the hybrid's table."""
    assert KmerConfig(k=8, mode="dense").effective_mode == "dense"
    assert KmerConfig(k=8).effective_mode == "sort"
    with pytest.raises(ValueError, match="k <= 12"):
        KmerConfig(k=13, mode="dense")
    hybrid = kmer_tpu_torch.count_fasta(genome, k=10, mode="dense",
                                        device="cpu", **SMALL)
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", "1")
    assert kmer_tpu_torch.count_fasta(genome, k=10, mode="dense",
                                      device="cpu", **SMALL) == hybrid


@pytest.mark.parametrize("k,canonical", [(9, True), (12, False)])
def test_dense_scatter_equals_hybrid_and_kmer_tpu(genome, monkeypatch, k,
                                                  canonical):
    kw = dict(k=k, canonical=canonical, mode="dense", **SMALL)
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", "0")
    hybrid = kmer_tpu_torch.count_fasta(genome, device="cpu", **kw)
    want = kmer_tpu.count_fasta(genome, **kw)
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", "1")
    hk.launches = 0
    got = kmer_tpu_torch.count_fasta(genome, device="cpu", **kw)
    assert got == hybrid == want and got.total == 300 * (150 - k + 1)
    assert kmer_tpu.count_fasta(genome, **kw) == want
    assert hk.launches == 0


def test_count_step_scatter_accumulates():
    (codes, lengths, limits), keys, counts = _k1_batch(10, 11, False)
    table = torch.zeros(4 ** 11, dtype=torch.int64)
    args = [torch.from_numpy(a) for a in (codes, lengths, limits)]
    for _ in range(2):
        assert count_step_scatter(*args, table, k=11,
                                  canonical=False) is table
    live = counts > 0
    want = np.bincount(keys[live].numpy(), weights=counts[live].numpy(),
                       minlength=4 ** 11)
    np.testing.assert_array_equal(table.numpy(), 2 * want.astype(np.int64))


def test_count_step_dense_accumulates():
    (codes, lengths, limits), keys, counts = _k1_batch(9, 6, True)
    hist = torch.zeros(4 ** 6, dtype=torch.int64)
    args = [torch.from_numpy(a) for a in (codes, lengths, limits)]
    for _ in range(2):
        count_step_dense(*args, hist, k=6, canonical=True)
    live = counts > 0
    want = np.bincount(keys[live].numpy(), weights=counts[live].numpy(),
                       minlength=4 ** 6)
    np.testing.assert_array_equal(hist.numpy(), 2 * want.astype(np.int64))


def test_estimate_multi_k_equals_kmer_tpu(genome, sample_fasta_path):
    for canonical in (False, True):
        jcfg = kmer_tpu.KmerConfig(k=21, canonical=canonical, **SMALL)
        cfg = KmerConfig(k=21, canonical=canonical, **SMALL)
        paths = [genome, sample_fasta_path]
        want = jax_estimate(paths, [11, 21, 11], jcfg, b=10)
        got = kmer_tpu_torch.estimate_distinct_multi_k(paths, [11, 21, 11],
                                                       cfg, b=10,
                                                       device="cpu")
        assert got == want and len(got) == 2
    from kmer_tpu.pipeline.sketch import estimate_distinct_files
    assert kmer_tpu_torch.estimate_distinct_files(
        genome, KmerConfig(k=21, **SMALL), device="cpu") == \
        estimate_distinct_files(genome, kmer_tpu.KmerConfig(k=21, **SMALL))
    with pytest.raises(ValueError, match="buckets_log2"):
        kmer_tpu_torch.estimate_distinct_multi_k(genome, [21], cfg, b=12,
                                                 device="cpu")


def test_card_cli_bytes(genome, sample_fasta_path, capsys):
    for extra in (["-k", "11", "-k", "21"],
                  ["-k", "31", "--canonical", "--buckets-log2", "11"]):
        args = ["card", genome, sample_fasta_path, *extra, "--batch-reads",
                "64", "--max-read-len", "96"]
        assert jax_main(args) == 0
        want = capsys.readouterr().out
        res = subprocess.run(
            [sys.executable, "-m", "kmer_tpu_torch", *args, "--device",
             "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout == want and "distinct_estimate" in want
    from kmer_tpu_torch.cli import main
    assert main(["card", genome, "--seed-mask", "11011", "-k", "21",
                 "--device", "cpu"]) == 1
    assert "--seed-mask" in capsys.readouterr().err


def test_cli_count_mode_dense_bytes(genome, capsys):
    args = ["count", genome, "-k", "7", "--mode", "dense", "--canonical",
            "--batch-reads", "64", "--max-read-len", "96"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    res = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == want and want.count("\n") > 1000
