"""The gapped slice as a whole on the CPU (the plain version of kernel K3):
count_fasta(gapped=True) gives tables bit-identical to kmer_tpu's, the
parity dump has the reference's md5 on sample.fasta in every mode, and
the CLI writes kmer_tpu's bytes.  Exact comparisons throughout."""

import hashlib
import io
import os
import subprocess
import sys

import pytest

import kmer_tpu
import kmer_tpu_torch
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import random_reads_fasta
from kmer_tpu.io.generator import reference_style_fasta as jax_reference_style
from kmer_tpu.utils import oracle
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.io.generator import reference_style_fasta
from kmer_tpu_torch.pipeline.parity import parity_dump, parity_dump_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (corpus, batch_reads, max_read_len): several batches of 400-base
# records; 700-base reads split at 256 with c_max - 1 overlap seams;
# records of 120, 80 (= c_min), 3 and 140 (= c_max) bases
CASES = {"multi": (3, 512), "long": (4, 256), "varlen": (256, 512)}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("gapped")
    texts = {
        "multi": reference_style_fasta(n_records=10, seed=4),
        "long": random_reads_fasta(3, 700, seed=6),
        "varlen": "".join([">a\n" + "ACGT" * 30 + "\n",
                           ">b\n" + "TTGCA" * 16 + "\n", ">c\nACG\n",
                           ">d\n" + "GATTACA" * 20 + "\n"]),
    }
    paths = {}
    for name, text in texts.items():
        paths[name] = str(d / f"{name}.fasta")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


@pytest.fixture(scope="module")
def jax_tables(corpora):
    """kmer_tpu's gapped tables, one per corpus (each compiles once)."""
    return {name: kmer_tpu.count_fasta(corpora[name], gapped=True,
                                       batch_reads=br, max_read_len=ml)
            for name, (br, ml) in CASES.items()}


def test_reference_style_fasta_same_text():
    for kw in (dict(n_records=7, seed=3), dict(n_records=1200, seed=0)):
        assert reference_style_fasta(**kw) == jax_reference_style(**kw)


@pytest.mark.parametrize("name", list(CASES))
def test_gapped_count_bit_identical(corpora, jax_tables, name):
    br, ml = CASES[name]
    got = kmer_tpu_torch.count_fasta(corpora[name], gapped=True,
                                     batch_reads=br, max_read_len=ml,
                                     device="cpu")
    want = jax_tables[name]
    assert got == want and got.total == want.total > 0
    assert got.keys.shape[1] == 4
    # the dump the table expands to is the independent oracle's
    seqs = oracle.read_fasta_py(corpora[name])
    assert (parity_dump(corpora[name], KmerConfig(
        gapped=True, batch_reads=br, max_read_len=ml), device="cpu")
        == oracle.oracle_gapped_sorted_dump(seqs))


def test_gapped_count_chunked_ingest(corpora, jax_tables):
    """Several ingest chunks merge to the same table."""
    got = kmer_tpu_torch.count_fasta(corpora["multi"], gapped=True,
                                     batch_reads=3, max_read_len=512,
                                     ingest_chunk_bases=1500, device="cpu")
    assert got == jax_tables["multi"]


def test_sample_fasta_md5_every_mode(sample_fasta_path, monkeypatch):
    """THE exactness contract: the md5 of the sorted dump, by count +
    expand, by the per-batch multiset sort, and bounded-memory with
    chunked ingest and 7 spill partitions -- all the same bytes."""
    dump = parity_dump(sample_fasta_path, device="cpu")
    assert hashlib.md5(dump).hexdigest() == kmer_tpu_torch.SAMPLE_FASTA_MD5
    assert dump.count(b"\n") == 3_550_200
    assert (kmer_tpu_torch.parity_md5(sample_fasta_path, device="cpu")
            == kmer_tpu_torch.SAMPLE_FASTA_MD5)
    monkeypatch.setenv("KMER_TPU_PARITY", "multiset")
    assert parity_dump(sample_fasta_path, device="cpu") == dump
    monkeypatch.delenv("KMER_TPU_PARITY")
    buf = io.BytesIO()
    parity_dump_stream(sample_fasta_path, buf, KmerConfig(
        gapped=True, batch_reads=256, max_read_len=512,
        ingest_chunk_bases=20000), partitions=7, device="cpu")
    assert buf.getvalue() == dump


@pytest.mark.parametrize("env", [dict(KMER_TPU_GAPPED_STEP="legacy")])
def test_sample_fasta_md5_unfused_route(sample_fasta_path, monkeypatch, env):
    """The md5 on the gapped unfused route (ROADMAP item 17: K7's gapped
    lanes and the grouped counts in place of K3), by count + expand and
    by the per-batch multiset sort."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    dump = parity_dump(sample_fasta_path, device="cpu")
    assert hashlib.md5(dump).hexdigest() == kmer_tpu_torch.SAMPLE_FASTA_MD5
    monkeypatch.setenv("KMER_TPU_PARITY", "multiset")
    assert parity_dump(sample_fasta_path, device="cpu") == dump


def test_multiset_and_bounded_multibatch(corpora, monkeypatch, tmp_path):
    """Per-batch sorted dumps (several batches, split reads) merge to the
    count + expand bytes."""
    for name in ("multi", "long"):
        br, ml = CASES[name]
        cfg = KmerConfig(gapped=True, batch_reads=br, max_read_len=ml)
        want = parity_dump(corpora[name], cfg, device="cpu")
        monkeypatch.setenv("KMER_TPU_PARITY", "multiset")
        assert parity_dump(corpora[name], cfg, device="cpu") == want
        monkeypatch.delenv("KMER_TPU_PARITY")
        buf = io.BytesIO()
        parity_dump_stream(corpora[name], buf, cfg,
                           spill_dir=str(tmp_path / name), partitions=5,
                           device="cpu")
        assert buf.getvalue() == want and not os.listdir(tmp_path / name)


def test_parity_empty_input(tmp_path):
    p = tmp_path / "short.fasta"
    p.write_text(">only_short\nACG\n")
    assert parity_dump(str(p), device="cpu") == b""
    buf = io.BytesIO()
    parity_dump_stream(str(p), buf, device="cpu")
    assert buf.getvalue() == b""


def test_cli_parity_md5(sample_fasta_path):
    """python -m kmer_tpu_torch parity ... | md5sum, in a fresh process."""
    res = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", "parity", sample_fasta_path,
         "--device", "cpu"], cwd=REPO, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert (hashlib.md5(res.stdout).hexdigest()
            == kmer_tpu_torch.SAMPLE_FASTA_MD5)


def test_cli_bytes_match_kmer_tpu(corpora, capsysbinary):
    from kmer_tpu_torch.cli import main
    fa = corpora["multi"]
    flags = ["--batch-reads", "3", "--max-read-len", "512"]
    for args in (["parity", fa] + flags,
                 ["parity", fa, "--bounded", "--partitions", "5"] + flags,
                 ["count", fa, "--gapped", "--min-count", "2"] + flags):
        assert jax_main(args) == 0
        want = capsysbinary.readouterr().out
        assert main(args + ["--device", "cpu"]) == 0
        assert capsysbinary.readouterr().out == want and len(want) > 1000


def test_cli_gapped_errors(corpora, capsys):
    from kmer_tpu_torch.cli import main
    fa = corpora["multi"]
    assert main(["count", fa, "--gapped", "--canonical", "--device",
                 "cpu"]) == 1
    assert "--canonical" in capsys.readouterr().err
    # a 32-base window counts (ROADMAP item 15), as kmer_tpu's
    wide = ["count", fa, "--gapped", "--l-len", "32", "--c-max", "90"]
    assert jax_main(wide) == 0
    want = capsys.readouterr().out
    assert main(wide + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.count("\n") > 100
    assert main(["count", fa, "--gapped", "--c-min", "40", "--device",
                 "cpu"]) == 1
    assert "c_min" in capsys.readouterr().err
