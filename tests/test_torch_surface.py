"""The saved-table surface of the port against kmer_tpu's on the CPU:
KmerTable's set operations and lookups at one to four key words, .npz
files written by either package and read by the other, the stdout bytes
and exit codes of `dump`, `query`, `tools` and `generate`, `--threads`,
the generators, BGZF bytes, and keys over 63 bases refused."""

import io
import json
import os
import sys

import numpy as np
import pytest

from kmer_tpu.cli import main as jax_main
from kmer_tpu.io import bgzf as jbgzf
from kmer_tpu.io import fasta as jf
from kmer_tpu.io import generator as jgen
from kmer_tpu.ops import encode as jenc
from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu_torch.cli import main as port_main
from kmer_tpu_torch.io import bgzf, generator
from kmer_tpu_torch.io import fasta as tf
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.pipeline.table import KmerTable

KS = [5, 15, 16, 21, 31, 32, 45, 63]


def _both(k, keys, counts):
    """The same (keys, counts) aggregated by each package."""
    t = KmerTable.from_pairs(k, keys, counts)
    j = JaxTable.from_pairs(k, keys, counts)
    assert t == j
    return t, j


def _operands(k, seed):
    """Tables A and B of random k-mers that share about a third of their
    keys, with small counts (ties, and B's counts often above A's)."""
    rng = np.random.default_rng(seed)
    pool = tenc.key_words_from_codes(
        rng.integers(0, 4, (600, k), dtype=np.uint8))
    a = rng.integers(0, 400, 700)
    b = rng.integers(250, 600, 500)
    return (_both(k, pool[a], rng.integers(1, 6, len(a))),
            _both(k, pool[b], rng.integers(1, 6, len(b))))


def _port(j):
    return KmerTable(j.k, j.keys.copy(), j.counts.copy())


@pytest.mark.parametrize("k", KS)
def test_key_words_from_code_rows(k):
    codes = np.random.default_rng(k).integers(0, 4, (50, k), dtype=np.uint8)
    want = np.stack([jenc.key_words_from_codes(c) for c in codes])
    np.testing.assert_array_equal(tenc.key_words_from_codes(codes), want)
    np.testing.assert_array_equal(tenc.key_words_from_codes(codes[0]),
                                  want[0])
    seq = tenc.decode_codes(codes[0])
    assert seq == jenc.decode_codes(codes[0])
    assert tenc.revcomp_str(seq) == jenc.revcomp_str(seq)


@pytest.mark.parametrize("k", KS)
def test_set_operations_match(k):
    (ta, ja), (tb, jb) = _operands(k, seed=k)
    te, je = KmerTable.empty(k), JaxTable.empty(k)
    jd = ja.subtract(jb, counters=False)          # disjoint from B
    assert 0 < jd.num_distinct < ja.num_distinct
    cases = [(ta, tb, ja, jb), (tb, ta, jb, ja), (ta, ta, ja, ja),
             (_port(jd), tb, jd, jb), (ta, te, ja, je), (te, tb, je, jb),
             (te, te, je, je)]
    for x, y, jx, jy in cases:
        assert x.merge(y) == jx.merge(jy)
        assert x.union(y) == jx.union(jy)
        assert x.intersect(y) == jx.intersect(jy)
        assert x.subtract(y) == jx.subtract(jy, counters=True)
        assert x.subtract(y, counters=False) == jx.subtract(jy,
                                                            counters=False)
        got = x.compare(y)
        assert json.dumps(got) == json.dumps(jx.compare(jy))
    assert ta.intersect(tb).num_distinct > 50
    assert ta.subtract(tb).total < ta.total
    assert ta.filter_min_count(3) == ja.filter_min_count(3)
    with pytest.raises(ValueError, match="table k mismatch"):
        ta.intersect(KmerTable.empty(k + 1))


@pytest.mark.parametrize("k", KS)
def test_lookups_match(k):
    (ta, ja), _ = _operands(k, seed=100 + k)
    rng = np.random.default_rng(k)
    present = ta.kmers()[::7]
    absent = [tenc.decode_codes(c)
              for c in rng.integers(0, 4, (40, k), dtype=np.uint8)]
    rcs = [tenc.revcomp_str(s) for s in present]
    queries = present + absent + rcs
    for canonical in (False, True):
        got = ta.get_many(queries, canonical=canonical)
        want = ja.get_many(queries, canonical=canonical)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        for q in queries[::9]:
            assert ta.get(q, canonical=canonical) == ja.get(
                q, canonical=canonical)
    assert (ta.get_many(present) > 0).all()
    assert ta.get_many([]).shape == (0,)
    np.testing.assert_array_equal(KmerTable.empty(k).get_many(queries),
                                  np.zeros(len(queries), np.int64))
    for n in (0, 1, 7, ta.num_distinct, ta.num_distinct + 5):
        assert ta.top(n) == ja.top(n)
    counts = [c for _, c in ta.top(ta.num_distinct)]
    assert len(set(counts)) < len(counts)           # ties in key order
    assert KmerTable.empty(k).top(3) == []
    bad = "A" * (k + 1)
    with pytest.raises(ValueError, match=f"expected a {k}-mer") as e:
        ta.get(bad)
    with pytest.raises(ValueError) as f:
        ja.get(bad)
    assert str(e.value) == str(f.value)


def test_over_63_bases_refused(tmp_path):
    """kmer_tpu's k = 64 table loads (ROADMAP item 18 ported it) and
    equals kmer_tpu's own load."""
    rng = np.random.default_rng(0)
    j = JaxTable.from_pairs(64, np.stack([
        jenc.key_words_from_codes(c)
        for c in rng.integers(0, 4, (5, 64), dtype=np.uint8)]),
        [3, 1, 4, 1, 5])
    j.save(str(tmp_path / "k64.npz"))
    t = KmerTable.load(str(tmp_path / "k64.npz"))
    assert t == JaxTable.load(str(tmp_path / "k64.npz")) == j


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """Saved tables: A, B and C at k = 21 (each saved by both packages),
    W at k = 45, a k = 15 table and an empty one."""
    d = tmp_path_factory.mktemp("npz")
    (ta, ja), (tb, jb) = _operands(21, seed=1)
    (tc, jc), (tw, jw) = _operands(21, seed=2)[0], _operands(45, seed=3)[0]
    paths = {}
    for name, (t, j) in dict(A=(ta, ja), B=(tb, jb), C=(tc, jc),
                             W=(tw, jw)).items():
        paths[name] = str(d / f"{name}_port.npz")
        t.save(paths[name])
        paths[name + "j"] = str(d / f"{name}_jax.npz")
        j.save(paths[name + "j"])
    paths["K15"] = str(d / "k15.npz")
    _operands(15, seed=4)[0][0].save(paths["K15"])
    paths["E"] = str(d / "empty.npz")
    KmerTable.empty(21).save(paths["E"])
    paths["kmers_A"] = ta.kmers()
    paths["kmers_W"] = tw.kmers()
    return paths


def _run_both(capsys, monkeypatch, argv, stdin=None):
    """(rc, stdout, stderr) of each package's main on one command line,
    asserted equal apart from the program name in error lines."""
    out = []
    for main, prog in ((jax_main, "kmer_tpu"), (port_main, "kmer_tpu_torch")):
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        rc = main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err.replace(f"{prog}: error:",
                                                 "PROG: error:")))
    assert out[0] == out[1]
    return out[0]


DUMP_CASES = [[], ["--min-count", "2"], ["--max-count", "3"],
              ["--min-count", "2", "--max-count", "4"], ["--histo"],
              ["--histo", "--min-count", "3"], ["--top", "5"],
              ["--top", "0"], ["--top", "9", "--max-count", "4"]]


@pytest.mark.parametrize("saver", ["", "j"])
@pytest.mark.parametrize("table", ["A", "W"])
@pytest.mark.parametrize("flags", DUMP_CASES, ids=" ".join)
def test_cli_dump_bytes(npz, capsys, monkeypatch, saver, table, flags):
    rc, out, _ = _run_both(capsys, monkeypatch,
                           ["dump", npz[table + saver], *flags])
    assert rc == 0 and bool(out) == (flags != ["--top", "0"])


@pytest.mark.parametrize("flags", [[], ["--histo"], ["--top", "3"]])
def test_cli_dump_empty(npz, capsys, monkeypatch, flags):
    assert _run_both(capsys, monkeypatch,
                     ["dump", npz["E"], *flags]) == (0, "", "")


@pytest.mark.parametrize("saver", ["", "j"])
@pytest.mark.parametrize("how", ["args", "stdin", "canonical",
                                 "canonical_stdin"])
def test_cli_query_bytes(npz, capsys, monkeypatch, saver, how):
    rng = np.random.default_rng(7)
    for table, km in (("A", npz["kmers_A"]), ("W", npz["kmers_W"])):
        k = len(km[0])
        queries = km[::11] + [tenc.revcomp_str(s) for s in km[::13]] + [
            tenc.decode_codes(c)
            for c in rng.integers(0, 4, (20, k), dtype=np.uint8)]
        argv = ["query", npz[table + saver]]
        if how.startswith("canonical"):
            argv.append("--canonical")
        if how.endswith("stdin"):
            text = "\n".join(queries) + "\n\n  \n"
            rc, out, _ = _run_both(capsys, monkeypatch, argv, stdin=text)
        else:
            rc, out, _ = _run_both(capsys, monkeypatch, argv + queries)
        assert rc == 0 and out.count("\n") == len(queries)
        assert "\t0\n" in out and "\t1\n" in out


def test_cli_query_errors(npz, capsys, monkeypatch):
    rc, out, err = _run_both(capsys, monkeypatch,
                             ["query", npz["A"], "ACGT"])
    assert (rc, out) == (1, "") and "expected a 21-mer" in err
    rc, out, err = _run_both(capsys, monkeypatch,
                             ["query", npz["A"], "ACGTN" + "A" * 16])
    assert (rc, out) == (1, "") and "invalid base 'N' at position 4" in err
    rc, out, err = _run_both(capsys, monkeypatch,
                             ["query", npz["E"], "A" * 21])
    assert (rc, out, err) == (0, "A" * 21 + "\t0\n", "")
    rc, out, err = _run_both(capsys, monkeypatch,
                             ["query", npz["A"] + ".missing", "A" * 21])
    assert rc == 1 and "No such file" in err
    # --canonical on a non-ACGT query: both fail in the reverse complement
    for main in (jax_main, port_main):
        with pytest.raises(KeyError):
            main(["query", npz["A"], "--canonical", "ACGTN" + "A" * 16])


TOOLS_CASES = [
    ["union", "A", "B", "C"], ["union", "A", "Bj"], ["union", "A", "E"],
    ["intersect", "A", "B"], ["intersect", "Aj", "B"], ["intersect", "A", "E"],
    ["subtract", "A", "B"], ["subtract", "B", "A"], ["subtract", "E", "A"],
    ["kmers-subtract", "A", "B"], ["kmers-subtract", "A", "A"],
    ["compare", "A", "B"], ["compare", "A", "E"], ["compare", "E", "E"],
    ["compare", "W", "Wj"], ["intersect", "W", "Wj"],
    ["union", "A", "B", "--min-count", "3"],
    ["intersect", "A", "B", "--max-count", "2"],
    ["subtract", "A", "B", "--min-count", "2", "--max-count", "3"],
    # errors
    ["intersect", "A", "K15"], ["union", "A", "B", "K15"],
    ["intersect", "A", "B", "C"], ["compare", "A", "B", "C"]]


@pytest.mark.parametrize("case", TOOLS_CASES, ids=" ".join)
def test_cli_tools_bytes(npz, capsys, monkeypatch, case):
    op, *rest = case
    argv = ["tools", op] + [npz.get(a, a) for a in rest]
    rc, out, err = _run_both(capsys, monkeypatch, argv)
    if "K15" in case:
        assert rc == 1 and "table k mismatch: 21 vs 15" in err
    elif op != "union" and len(rest) > 2 and rest[2] == "C":
        assert rc == 1 and f"{op} takes exactly one B table" in err
    else:
        assert rc == 0 and err == ""
        if op == "compare":
            assert json.loads(out)["k"] in (21, 45)


def test_cli_tools_out_npz(npz, tmp_path, capsys, monkeypatch):
    outs = []
    for main, name in ((jax_main, "j"), (port_main, "t")):
        p = str(tmp_path / f"{name}.npz")
        assert main(["tools", "union", npz["A"], npz["B"], npz["Cj"],
                     "-o", p, "--min-count", "2"]) == 0
        outs.append((capsys.readouterr().out, KmerTable.load(p),
                     JaxTable.load(p)))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][2] and outs[1][1] == outs[0][2]


GENERATE_CASES = [
    [], ["--seed", "3", "--n-records", "7"],
    ["--style", "reads", "--n-records", "5", "--read-len", "33",
     "--seed", "1"],
    ["--style", "genome", "--n-records", "6", "--read-len", "40",
     "--genome-len", "500", "--error-rate", "0.05", "--seed", "2"],
    ["--style", "genome", "--n-records", "3", "--read-len", "40",
     "--genome-len", "40"],
    ["--format", "fastq", "--n-records", "4", "--read-len", "20",
     "--seed", "5"],
    ["--format", "fastq", "--style", "genome", "--n-records", "2"],
    ["--style", "genome", "--read-len", "600", "--genome-len", "500"]]


@pytest.mark.parametrize("flags", GENERATE_CASES, ids=" ".join)
def test_cli_generate_bytes(capsys, monkeypatch, flags):
    rc, out, err = _run_both(capsys, monkeypatch, ["generate", *flags])
    if "600" in flags:
        assert rc == 1 and "read_len=600 > genome_len=500" in err
    else:
        assert rc == 0 and out.count("\n") > 3


@pytest.mark.parametrize("wrap", [None, 1, 7, 60, 150, 200])
def test_random_reads_fasta_wrap(wrap):
    for n, L, seed in ((5, 150, 0), (3, 61, 9), (2, 0, 1)):
        assert generator.random_reads_fasta(n, L, seed=seed, wrap=wrap) == \
            jgen.random_reads_fasta(n, L, seed=seed, wrap=wrap)


@pytest.mark.parametrize("qual_range", [None, (2, 41), (30, 31), (0, 94)])
def test_random_reads_fastq(qual_range):
    for n, L, seed in ((6, 100, 0), (2, 1, 4)):
        assert generator.random_reads_fastq(
            n, L, seed=seed, qual_range=qual_range) == \
            jgen.random_reads_fastq(n, L, seed=seed, qual_range=qual_range)


def test_random_codes():
    for seed in (0, 5):
        got = generator.random_codes(9, 31, seed=seed)
        np.testing.assert_array_equal(got, jgen.random_codes(9, 31,
                                                             seed=seed))
        assert got.dtype == np.uint8


@pytest.mark.parametrize("size,block", [(0, 65280), (1, 65280),
                                        (65280, 65280), (65281, 65280),
                                        (200_000, 65280), (10_000, 1000),
                                        (999, 1)])
def test_bgzf_compress_bytes(size, block):
    rng = np.random.default_rng(size)
    data = jgen.random_reads_fasta(max(size // 160, 1), 150, seed=size
                                   ).encode()[:size]
    data += bytes(rng.integers(0, 256, size - len(data), dtype=np.uint8))
    assert bgzf.bgzf_compress(data, block) == jbgzf.bgzf_compress(data,
                                                                  block)


@pytest.mark.parametrize("block", [65280, 1000, 100])
def test_bgzf_compress_many_blocks(monkeypatch, block):
    """Blocks compressed on several threads (hundreds of blocks, one
    thread or five) give the reference's bytes, in its block order."""
    data = jgen.random_reads_fasta(2000, 150, seed=block).encode()
    want = jbgzf.bgzf_compress(data, block)
    for cpus in (1, 5):
        monkeypatch.setattr(bgzf.os, "cpu_count", lambda: cpus)
        assert bgzf.bgzf_compress(data, block) == want


def test_write_bgzf_and_bounds(tmp_path):
    text = generator.random_reads_fasta(50, 100, seed=3)
    bgzf.write_bgzf(str(tmp_path / "t.gz"), text)
    jbgzf.write_bgzf(str(tmp_path / "j.gz"), text.encode())
    assert (tmp_path / "t.gz").read_bytes() == (tmp_path / "j.gz").read_bytes()
    for block in (0, bgzf.MAX_BLOCK_UDATA + 1):
        with pytest.raises(ValueError):
            bgzf.bgzf_compress(b"ACGT", block)


def test_parse_threads_reads_the_variable(monkeypatch):
    for env in ("5", "1", "0", "-3", "32"):
        monkeypatch.setenv("KMER_TPU_PARSE_THREADS", env)
        assert tf._parse_threads() == jf._parse_threads() == max(1, int(env))
    monkeypatch.delenv("KMER_TPU_PARSE_THREADS")
    assert tf._parse_threads() == jf._parse_threads() == min(
        os.cpu_count() or 1, 8)


@pytest.mark.parametrize("fmt", ["fasta", "bgzf"])
def test_threads_flag_same_tsv(tmp_path, capsys, monkeypatch, fmt):
    """--threads 1 and 3 print the same TSV, kmer_tpu's, and set the
    variable the native parser reads."""
    monkeypatch.setenv("KMER_TPU_PARSE_THREADS", "2")   # restored after
    text = generator.genome_reads_fasta(300, 120, genome_len=3000, seed=4,
                                        error_rate=0.01)
    path = str(tmp_path / "r.fa")
    if fmt == "bgzf":
        path += ".gz"
        bgzf.write_bgzf(path, text, block=4096)
    else:
        with open(path, "w") as f:
            f.write(text)
    args = ["count", path, "-k", "21", "--canonical", "--batch-reads", "64",
            "--max-read-len", "128"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    for threads in ("1", "3"):
        assert port_main(args + ["--threads", threads,
                                 "--device", "cpu"]) == 0
        assert capsys.readouterr().out == want
        assert os.environ["KMER_TPU_PARSE_THREADS"] == threads
    assert want.count("\n") > 1000
