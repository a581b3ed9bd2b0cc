"""The slice as a whole: kmer_tpu_torch.count_fasta on the CPU (the
plain torch version of the kernel) gives tables bit-identical to
kmer_tpu.count_fasta in sort mode; the CLI writes the same TSV; the
package never imports jax or kmer_tpu."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import kmer_tpu
import kmer_tpu_torch
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import genome_reads_fasta, random_reads_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kmer_tpu_torch")
# several batches, and records split with overlap seams (reads of 150
# and 400 bases in 96-base rows)
SMALL = dict(batch_reads=64, max_read_len=96)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, sample_fasta_path):
    d = tmp_path_factory.mktemp("count")
    g = d / "genome.fasta"
    g.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=1,
                                    error_rate=0.01))
    return {"sample": sample_fasta_path, "genome": str(g)}


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [5, 11, 15, 16, 21, 31])
@pytest.mark.parametrize("corpus", ["sample", "genome"])
def test_count_fasta_bit_identical(corpora, corpus, k, canonical):
    path = corpora[corpus]
    want = kmer_tpu.count_fasta(path, k=k, canonical=canonical, mode="sort",
                                **SMALL)
    got = kmer_tpu_torch.count_fasta(path, k=k, canonical=canonical,
                                     device="cpu", **SMALL)
    assert got == want
    assert got.total == want.total > 0


def test_skip_invalid_and_min_qual(tmp_path):
    rng = np.random.default_rng(2)
    seqs = rng.choice(list("ACGTN"), size=(40, 130), p=[.24, .24, .24, .24,
                                                         .04])
    fa = tmp_path / "n.fasta"
    fa.write_text("".join(f">r{i}\n{''.join(s)}\n" for i, s in
                          enumerate(seqs)))
    fq = tmp_path / "q.fastq"
    fq.write_text(random_reads_fastq(40, 110, seed=5, qual_range=(20, 41)))
    for path, mq in ((str(fa), 0), (str(fq), 22)):
        for canonical in (True, False):
            kw = dict(k=21, canonical=canonical, skip_invalid=True,
                      min_qual=mq, **SMALL)
            want = kmer_tpu.count_fasta(path, mode="sort", **kw)
            got = kmer_tpu_torch.count_fasta(path, device="cpu", **kw)
            assert got == want and got.total > 0
    with pytest.raises(ValueError):
        kmer_tpu_torch.count_fasta(str(fa), k=21, device="cpu")


def test_count_files_chunked_and_empty(corpora, tmp_path):
    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    paths = [corpora["sample"], str(empty), corpora["genome"]]
    kw = dict(k=21, canonical=True, ingest_chunk_bases=20000, **SMALL)
    want = kmer_tpu.count_files(paths, mode="sort", **kw)
    assert kmer_tpu_torch.count_files(paths, device="cpu", **kw) == want
    e = kmer_tpu_torch.count_fasta(str(empty), k=21, device="cpu")
    assert e == kmer_tpu.count_fasta(str(empty), k=21, mode="sort")
    assert e.num_distinct == 0 and e.keys.shape == (0, 2)


def test_cli_tsv_and_npz_byte_identical(corpora, tmp_path, capsys):
    args = ["count", corpora["sample"], corpora["genome"], "-k", "21",
            "--canonical", "--batch-reads", "64", "--max-read-len", "96",
            "--min-count", "2", "--max-count", "40"]
    assert jax_main(args + ["--out-npz", str(tmp_path / "j.npz")]) == 0
    want = capsys.readouterr().out
    res = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", *args, "--device", "cpu",
         "--out-npz", str(tmp_path / "t.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == want and want.count("\n") > 100
    a = kmer_tpu_torch.KmerTable.load(str(tmp_path / "t.npz"))
    assert a == kmer_tpu.KmerTable.load(str(tmp_path / "j.npz"))


def test_cli_errors(tmp_path, capsys):
    from kmer_tpu_torch.cli import main
    bad = tmp_path / "bad.fasta"
    bad.write_text(">r\nACGTN\n")
    assert main(["count", str(bad), "--device", "cpu"]) == 1
    assert "invalid base" in capsys.readouterr().err
    assert main(["count", str(bad), "-k", "40", "--device", "cpu"]) == 1
    assert "ROADMAP" in capsys.readouterr().err


def test_port_never_imports_jax_or_kmer_tpu(corpora):
    """In a fresh interpreter: import the port and count on the CPU."""
    code = (
        "import sys, kmer_tpu_torch as kt\n"
        f"t = kt.count_fasta({corpora['sample']!r}, k=21, canonical=True, "
        "device='cpu', batch_reads=64, max_read_len=96)\n"
        "assert t.total > 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kmer_tpu')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    # and no source line of the package names them
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|kmer_tpu)\b", re.M)
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert not pat.search(src), f


def test_cuda_without_gpu_raises(corpora, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kmer_tpu_torch.count_fasta(corpora["sample"], k=21, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        kmer_tpu_torch.count_fasta(corpora["sample"], k=21)
