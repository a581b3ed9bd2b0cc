"""Streaming two-pass counting with checkpoint/resume
(kmer_tpu_torch.pipeline.streaming) against kmer_tpu on the CPU, exactly:

- the final table equals kmer_tpu's in-memory table (and kmer_tpu's own
  streaming table) for contiguous, canonical, spaced, gapped,
  skip-invalid, gzip and BGZF inputs, on both pass-1 routes: a batch at a
  time, and through the device-resident table (DeviceMerge) with its
  drain-commits;
- the table is the same after 0 or N interruptions: a fresh counter
  after every pass-1 batch, every drain-commit and every pass-2
  partition, after a torn append and after a crash between drains;
  resumed runs count the same batches at the same indices across chunk
  boundaries at tight widths;
- the spill directory: a mismatched config, and a directory written by
  kmer_tpu or by another format version, are refused; counts past 2**31
  survive pass 2; the fused-key routing gives route_partition's ids;
- the ingest resume cursors and batch skips equal kmer_tpu's;
- `count --two-pass` and `histo [--two-pass]` print what `python -m
  kmer_tpu` prints.
"""

import gzip
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io import fasta as jf
from kmer_tpu.io.bgzf import write_bgzf
from kmer_tpu.io.generator import (genome_reads_fasta, random_reads_fasta,
                                   reference_style_fasta)
from kmer_tpu.ops.encode import key_words_from_codes
from kmer_tpu.pipeline.streaming import StreamingCounter as JaxCounter
from kmer_tpu.pipeline.streaming import route_partition as jax_route
from kmer_tpu.utils import oracle
import kmer_tpu_torch
from kmer_tpu_torch import KmerConfig, StreamingCounter, stream_count_fasta
from kmer_tpu_torch.cli import main as port_main
from kmer_tpu_torch.io import fasta as tf
from kmer_tpu_torch.pipeline import count as tcount
from kmer_tpu_torch.pipeline import streaming
from kmer_tpu_torch.pipeline.table import KmerTable, fuse_words

from test_torch_count import REPO

CPU = dict(device="cpu")


def _cfg(**kw):
    base = dict(k=21, mode="sort", batch_reads=16, max_read_len=64,
                partitions=8)
    base.update(kw)
    return KmerConfig(**base)


def _jax_table(path, cfg):
    """kmer_tpu's in-memory table for the port's config."""
    fields = {f: getattr(cfg, f) for f in (
        "k", "canonical", "batch_reads", "max_read_len", "gapped", "l_len",
        "r_len", "c_min", "c_max", "skip_invalid", "min_qual", "seed_mask",
        "ingest_chunk_bases", "sort_group_keys")}
    return kmer_tpu.count_fasta(path, mode="sort", **fields)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """name -> path: random reads (several batches at batch_reads 16),
    and genome reads of mixed lengths for tight widths and seams."""
    d = tmp_path_factory.mktemp("stream")
    paths = {}
    for name, text in (
            ("r60", random_reads_fasta(60, 70, seed=4)),
            ("g40", genome_reads_fasta(40, 120, genome_len=900, seed=6,
                                       error_rate=0.02))):
        p = d / f"{name}.fasta"
        p.write_text(text)
        paths[name] = str(p)
    rng = np.random.default_rng(7)
    lens = np.concatenate([rng.integers(20, 60, 30), rng.integers(90, 200, 12),
                           rng.integers(30, 50, 20)])
    mixed = d / "mixed.fasta"
    mixed.write_text("".join(
        f">m{i}\n{''.join(rng.choice(list('ACGT'), n))}\n"
        for i, n in enumerate(lens)))
    paths["mixed"] = str(mixed)
    return paths


@pytest.fixture(scope="module")
def want_r60(corpus):
    return _jax_table(corpus["r60"], _cfg())


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("n_bases", [5, 9, 16, 21, 31, 33, 45, 48, 63])
@pytest.mark.parametrize("parts", [1, 3, 8, 16, 1000])
def test_route_fused_equals_route_partition(n_bases, parts):
    """W = 1..4: the ids of the fused keys equal kmer_tpu's of the
    unfused words, and they do not decrease along sorted keys."""
    rng = np.random.default_rng(n_bases * 7 + parts)
    codes = rng.integers(0, 4, (400, n_bases))
    words = np.stack([key_words_from_codes(c, n_bases) for c in codes])
    fused = fuse_words(words, n_bases)
    got = streaming.route_fused(fused, n_bases, parts)
    np.testing.assert_array_equal(got, jax_route(words, n_bases, parts))
    order = (np.argsort(fused) if fused.ndim == 1
             else np.lexsort((fused[:, 1], fused[:, 0])))
    assert np.all(np.diff(got[order]) >= 0)
    assert got.min() >= 0 and got.max() < parts


# ------------------------------------------------ tables against kmer_tpu

@pytest.mark.parametrize("k,canonical", [(21, False), (21, True), (9, False),
                                         (55, True)])
def test_streaming_matches_in_memory(corpus, tmp_path, k, canonical):
    cfg = _cfg(k=k, canonical=canonical)
    want = _jax_table(corpus["r60"], cfg)
    got = stream_count_fasta(corpus["r60"], cfg,
                             spill_dir=str(tmp_path / "sp"), **CPU)
    assert got == want and got.total == 60 * (70 - k + 1)


def test_streaming_equals_kmer_tpu_streaming(corpus, tmp_path):
    """Both packages' two-pass tables, and the partitions one by one."""
    cfg = _cfg(canonical=True, partitions=5)
    jsc = JaxCounter(corpus["g40"], kmer_tpu.KmerConfig(
        k=21, canonical=True, mode="sort", batch_reads=16, max_read_len=64,
        partitions=5), str(tmp_path / "jax"))
    jsc.run()
    sc = StreamingCounter(corpus["g40"], cfg, str(tmp_path / "port"), **CPU)
    sc.run()
    for (p, t), (jp, jt) in zip(sc.partition_tables(), jsc.partition_tables()):
        assert p == jp and t == jt
    assert sc.final_table() == jsc.final_table()
    assert sc.multiplicity_histogram() == jsc.multiplicity_histogram()


@pytest.mark.parametrize("route", ["off", "on"])
def test_streaming_gapped_mode(tmp_path, route):
    path = tmp_path / "g.fasta"
    path.write_text(reference_style_fasta(n_records=6, seed=1))
    cfg = KmerConfig(gapped=True, mode="sort", batch_reads=8,
                     max_read_len=256, partitions=4, device_merge=route)
    sc = StreamingCounter(str(path), cfg, str(tmp_path / "sp"), **CPU)
    sc.run_pass1(max_batches=1)
    sc = StreamingCounter(str(path), cfg, str(tmp_path / "sp"), **CPU)
    sc.run()
    table = sc.final_table()
    chunks = Counter(oracle.oracle_gapped_lines(
        oracle.read_fasta_py(str(path))))
    assert table.to_dict() == dict(chunks)
    assert table == _jax_table(str(path), cfg)


def test_spaced_two_pass_streaming(tmp_path):
    p = tmp_path / "s2p.fasta"
    p.write_text(genome_reads_fasta(50, 120, genome_len=2500, seed=31))
    mask = "1101011"
    cfg = KmerConfig(seed_mask=mask, canonical=True, batch_reads=8,
                     max_read_len=64, sort_group_keys=64, partitions=4,
                     ingest_chunk_bases=1 << 12)
    want = _jax_table(str(p), cfg)
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"), **CPU)
    sc.run_pass1(max_batches=2)
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"), **CPU)
    sc.run()
    assert sc.final_table() == want
    assert want.to_dict() == dict(oracle.oracle_spaced_count(
        oracle.read_fasta_py(str(p)), mask, canonical=True))


def test_skip_invalid_streaming(tmp_path):
    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("ACGTNR"), 45,
                               p=[.24, .24, .24, .24, .02, .02]))
            for _ in range(24)]
    p = tmp_path / "n.fasta"
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    cfg = KmerConfig(k=7, mode="sort", batch_reads=8, max_read_len=32,
                     partitions=4, skip_invalid=True)
    got = stream_count_fasta(str(p), cfg, spill_dir=str(tmp_path / "sp"),
                             **CPU)
    want = oracle.oracle_count(seqs, 7, skip_invalid=True)
    assert got.to_dict() == dict(want) and got == _jax_table(str(p), cfg)


def test_bgzf_two_pass_streaming_resume(tmp_path):
    text = genome_reads_fasta(120, 100, genome_len=2500, seed=44)
    bgz = tmp_path / "tp.fasta.bgz"
    write_bgzf(str(bgz), text, block=2048)
    cfg = KmerConfig(k=21, canonical=True, batch_reads=8, max_read_len=128,
                     partitions=4, ingest_chunk_bases=1 << 12)
    want = _jax_table(str(bgz), cfg)
    sc = StreamingCounter(str(bgz), cfg, str(tmp_path / "sp"), **CPU)
    sc.run_pass1(max_batches=7)            # past the first chunk
    assert sc.state["pass1_cursor"] > 0
    sc = StreamingCounter(str(bgz), cfg, str(tmp_path / "sp"), **CPU)
    sc.run()
    assert sc.final_table() == want


def test_chunked_gzip_resume_after_every_batch(tmp_path):
    """gzip through the chunked native handle, a fresh counter after
    every batch: the cursor moves past completed chunks."""
    text = random_reads_fasta(30, 80, seed=45)
    gzp = tmp_path / "g.fasta.gz"
    with gzip.open(gzp, "wt") as f:
        f.write(text)
    cfg = KmerConfig(k=15, batch_reads=8, max_read_len=96,
                     ingest_chunk_bases=700, partitions=4)
    want = _jax_table(str(gzp), cfg.replace(ingest_chunk_bases=0))
    sp = str(tmp_path / "sp")
    cursors = set()
    sc = StreamingCounter(str(gzp), cfg, sp, **CPU)
    while not sc.state["pass1_done"]:
        sc.run_pass1(max_batches=1)
        sc = StreamingCounter(str(gzp), cfg, sp, **CPU)
        cursors.add(sc.state["pass1_cursor"])
    assert len(cursors) > 2
    sc.run_pass2()
    assert sc.final_table() == want


# ------------------------------------------------------- interruptions

def test_resume_mid_pass1(corpus, tmp_path, want_r60):
    sp = str(tmp_path / "sp")
    sc1 = StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)
    sc1.run_pass1(max_batches=2)
    assert not sc1.state["pass1_done"]
    sc2 = StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)
    assert sc2.state["pass1_next_batch"] == 2
    sc2.run()
    assert sc2.final_table() == want_r60


@pytest.mark.parametrize("route", ["off", "on"])
def test_resume_whole_file_ingest(corpus, tmp_path, want_r60, route):
    """ingest_chunk_bases = 0 parses the file whole and has no cursor: a
    resume parses it again and skips the counted batches."""
    cfg = _cfg(ingest_chunk_bases=0, device_merge=route)
    sp = str(tmp_path / "sp")
    StreamingCounter(corpus["r60"], cfg, sp, **CPU).run_pass1(max_batches=2)
    sc = StreamingCounter(corpus["r60"], cfg, sp, **CPU)
    assert sc.state["pass1_next_batch"] == 2 and sc.state["pass1_cursor"] == 0
    sc.run()
    assert sc.final_table() == want_r60


def test_resume_after_torn_append(corpus, tmp_path, want_r60):
    """A crash mid-append leaves a spill file longer than the manifest
    says: the resume truncates it back."""
    sp = tmp_path / "sp"
    sc1 = StreamingCounter(corpus["r60"], _cfg(), str(sp), **CPU)
    sc1.run_pass1(max_batches=1)
    with open(sp / "part_00000.bin", "ab") as f:
        f.write(b"\xde\xad\xbe\xef" * 7)
    sc2 = StreamingCounter(corpus["r60"], _cfg(), str(sp), **CPU)
    sc2.run()
    assert sc2.final_table() == want_r60


def test_spill_shorter_than_manifest_refused(corpus, tmp_path):
    sp = tmp_path / "sp"
    sc = StreamingCounter(corpus["r60"], _cfg(), str(sp), **CPU)
    sc.run_pass1(max_batches=1)
    victim = next(p for p in sorted(sp.glob("part_*.bin"))
                  if p.stat().st_size)
    with open(victim, "r+b") as f:
        f.truncate(victim.stat().st_size - 16)
    sc = StreamingCounter(corpus["r60"], _cfg(), str(sp), **CPU)
    with pytest.raises(ValueError, match="the manifest"):
        sc.run_pass1()


def test_resume_mid_pass2(corpus, tmp_path, want_r60):
    sp = str(tmp_path / "sp")
    sc1 = StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)
    sc1.run_pass1()
    sc1.run_pass2()
    sc1.state["pass2_done"][3] = False
    sc1.state["pass2_done"][5] = False
    sc1._checkpoint()
    sc2 = StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)
    with pytest.raises(RuntimeError, match="partition 3"):
        sc2.final_table()
    sc2.run()
    assert sc2.final_table() == want_r60


def _manifest(sp):
    with open(os.path.join(sp, "manifest.json")) as f:
        return json.load(f)


class _Crash(Exception):
    pass


def _crash_after_checkpoints(sc, n):
    """Make sc's n-th checkpoint from now its last act: the manifest is
    written, then the process 'dies'."""
    orig, left = sc._checkpoint, [n]

    def checkpoint():
        orig()
        left[0] -= 1
        if left[0] == 0:
            raise _Crash
    sc._checkpoint = checkpoint


@pytest.mark.parametrize("how", ["pause", "crash"])
@pytest.mark.parametrize("route", ["off", "on"])
def test_interruption_matrix(corpus, tmp_path, route, how):
    """A fresh counter after every pass-1 unit (a pause after each batch,
    or a crash right after each checkpoint: a batch, a drain-commit, a
    chunk's cursor) and after every pass-2 partition; the manifest on
    disk is the state at every step, and the table equals an
    uninterrupted run's and kmer_tpu's."""
    cfg = _cfg(canonical=True, ingest_chunk_bases=1500, partitions=4,
               device_merge=route)
    want = _jax_table(corpus["g40"], cfg)
    ref = StreamingCounter(corpus["g40"], cfg, str(tmp_path / "whole"), **CPU)
    ref.run()
    assert ref.final_table() == want
    sp = str(tmp_path / "sp")
    steps = 0
    while True:
        sc = StreamingCounter(corpus["g40"], cfg, sp, **CPU)
        assert _manifest(sp) == sc.state
        if sc.state["pass1_done"]:
            break
        if how == "pause":
            sc.run_pass1(max_batches=1)
        else:
            _crash_after_checkpoints(sc, 1)
            with pytest.raises(_Crash):
                sc.run_pass1()
        steps += 1
    assert steps >= 5
    if route == "off":
        assert sc.state["part_bytes"] == ref.state["part_bytes"]
    for p in range(cfg.partitions):
        sc = StreamingCounter(corpus["g40"], cfg, sp, **CPU)
        assert sc.state["pass2_done"] == [q < p for q in range(4)]
        _crash_after_checkpoints(sc, 1)
        with pytest.raises(_Crash):
            sc.run_pass2()
    sc = StreamingCounter(corpus["g40"], cfg, sp, **CPU)
    assert all(sc.state["pass2_done"])
    assert sc.final_table() == want


def test_resumed_batches_keep_their_indices(corpus, tmp_path, monkeypatch):
    """Chunks of mixed record lengths get different tight widths, and
    long records split; a run interrupted after every batch counts the
    same batches at the same global indices as an uninterrupted one."""
    cfg = KmerConfig(k=11, batch_reads=4, max_read_len=128, partitions=3,
                     ingest_chunk_bases=900)
    seen = {}

    def spy(self, i, rb):
        seen.setdefault(self.sc.dir, []).append(
            (i, tuple(int(p.sum()) for p in rb.planes), rb.planes[0].shape))
        orig(self, i, rb)
    orig = streaming._BatchPass.add
    monkeypatch.setattr(streaming._BatchPass, "add", spy)
    whole, sp = str(tmp_path / "whole"), str(tmp_path / "sp")
    StreamingCounter(corpus["mixed"], cfg, whole, **CPU).run()
    while True:
        sc = StreamingCounter(corpus["mixed"], cfg, sp, **CPU)
        if sc.state["pass1_done"]:
            break
        sc.run_pass1(max_batches=1)
    sc.run_pass2()
    widths = {shape for _, _, shape in seen[whole]}
    assert len(widths) > 1                       # tight widths differ
    assert seen[sp] == seen[whole]
    assert [i for i, _, _ in seen[whole]] == list(range(len(seen[whole])))
    assert sc.final_table() == _jax_table(corpus["mixed"], cfg)


def test_partition_count_invariance(corpus, tmp_path, want_r60):
    for P in (1, 4, 32):
        t = stream_count_fasta(corpus["r60"], _cfg(partitions=P),
                               spill_dir=str(tmp_path / f"sp{P}"), **CPU)
        assert t == want_r60


def test_streaming_tsv_and_histogram(corpus, tmp_path):
    import io
    sc = StreamingCounter(corpus["g40"], _cfg(), str(tmp_path / "sp"), **CPU)
    sc.run()
    buf, buf2 = io.StringIO(), io.StringIO()
    sc.write_tsv(buf)
    table = sc.final_table()
    table.write_tsv(buf2)
    assert buf.getvalue() == buf2.getvalue()
    jtable = _jax_table(corpus["g40"], _cfg())
    assert sc.multiplicity_histogram() == jtable.multiplicity_histogram() \
        == table.multiplicity_histogram()
    assert KmerTable.empty(21).multiplicity_histogram() == {}


def test_cleanup(corpus, tmp_path):
    sp = tmp_path / "sp"
    sc = StreamingCounter(corpus["r60"], _cfg(partitions=2), str(sp), **CPU)
    sc.run()
    sc.cleanup()
    assert not list(sp.glob("part_*")) and len(list(sp.glob("table_*"))) == 2
    sc.cleanup(keep_tables=False)
    assert not list(sp.iterdir())


# --------------------------------------------------- the spill directory

def test_mismatched_config_rejected(corpus, tmp_path):
    sp = str(tmp_path / "sp")
    StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)
    with pytest.raises(ValueError, match="different run"):
        StreamingCounter(corpus["r60"], _cfg(k=19), sp, **CPU)
    # the tables do not depend on the device or the pass-1 route
    StreamingCounter(corpus["r60"], _cfg(device_merge="on"), sp, **CPU)


def test_kmer_tpu_spill_dir_refused(corpus, tmp_path):
    sp = str(tmp_path / "sp")
    jsc = JaxCounter(corpus["r60"], kmer_tpu.KmerConfig(
        k=21, mode="sort", batch_reads=16, max_read_len=64, partitions=8), sp)
    jsc.run_pass1(max_batches=1)
    with pytest.raises(ValueError, match="format kmer_tpu version 3"):
        StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)


def test_other_format_version_refused(corpus, tmp_path):
    sp = str(tmp_path / "sp")
    StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)
    state = _manifest(sp)
    state["fingerprint"]["version"] = streaming.SPILL_VERSION + 1
    with open(os.path.join(sp, "manifest.json"), "w") as f:
        json.dump(state, f)
    with pytest.raises(ValueError, match="format kmer_tpu_torch version"):
        StreamingCounter(corpus["r60"], _cfg(), sp, **CPU)


@pytest.mark.parametrize("k", [21, 45])
def test_counts_past_2_31_survive_pass2(tmp_path, k):
    """int64 counts end to end: three spills of one key whose counts sum
    past 2**32, beside a key spilled once."""
    p = tmp_path / "e.fasta"
    p.write_text(">e\nACGT\n")
    cfg = KmerConfig(k=k, partitions=2)
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"), **CPU)
    words = np.stack([key_words_from_codes(np.full(k, c), k) for c in (1, 2)])
    fused = fuse_words(words, k)
    for c in (2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5):
        sc._spill(fused[:1], np.array([c], np.int64))
    sc._spill(fused[1:], np.array([2 ** 40], np.int64))
    sc.state["pass1_done"] = True
    sc._checkpoint()
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"), **CPU)
    sc.run_pass2()
    t = sc.final_table()
    np.testing.assert_array_equal(t.keys, words)
    assert t.counts.tolist() == [2 ** 33 + 4, 2 ** 40]


def test_cuda_without_gpu_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingCounter(corpus["r60"], _cfg(), str(tmp_path / "sp"))


# ------------------------------------------------------- the device merge

def test_devmerge_bit_identity(tmp_path, monkeypatch):
    """Forced device merge == the per-batch route == kmer_tpu, with a
    tiny fixed capacity and a fresh counter after every batch."""
    fa = tmp_path / "sdm.fasta"
    fa.write_text(random_reads_fasta(33, 80, seed=13))
    cfg = KmerConfig(k=21, canonical=True, batch_reads=4, max_read_len=96,
                     partitions=3)
    want = _jax_table(str(fa), cfg)
    monkeypatch.setenv("KMER_TPU_DEVMERGE", "0")
    assert stream_count_fasta(str(fa), cfg, spill_dir=str(tmp_path / "ref"),
                              **CPU) == want
    monkeypatch.setenv("KMER_TPU_DEVMERGE", "1")
    drains = []
    orig = tcount.DeviceMerge.drain
    monkeypatch.setattr(tcount.DeviceMerge, "drain",
                        lambda self: drains.append(1) or orig(self))
    assert stream_count_fasta(str(fa), cfg, spill_dir=str(tmp_path / "dm"),
                              **CPU) == want
    assert drains
    monkeypatch.setenv("KMER_TPU_DEVMERGE_ROWS", "512")
    assert stream_count_fasta(str(fa), cfg, spill_dir=str(tmp_path / "dm2"),
                              **CPU) == want
    monkeypatch.delenv("KMER_TPU_DEVMERGE_ROWS")
    d3 = str(tmp_path / "dm3")
    for _ in range(40):
        sc3 = StreamingCounter(str(fa), cfg, d3, **CPU)
        if sc3.state["pass1_done"]:
            break
        sc3.run_pass1(max_batches=1)
    else:
        raise AssertionError("pass 1 did not finish")
    sc3.run()
    assert sc3.final_table() == want


def test_devmerge_growth(tmp_path, monkeypatch):
    """Distinct keys past the first capacity grow the state (no drain
    before the commit)."""
    from kmer_tpu_torch.ops import devmerge as dm
    fa = tmp_path / "sdg.fasta"
    fa.write_text(random_reads_fasta(60, 64, seed=15))
    cfg = KmerConfig(k=15, batch_reads=8, max_read_len=64, partitions=3,
                     device_merge="on")
    orig, orig_grow = dm.empty_state, dm.grow_state
    grown = []
    monkeypatch.setattr(dm, "empty_state",
                        lambda r, w, device: orig(min(r, 2048), w, device))
    monkeypatch.setattr(dm, "grow_state", lambda w, c, n: grown.append(n)
                        or orig_grow(w, c, n))
    got = stream_count_fasta(str(fa), cfg, spill_dir=str(tmp_path / "dmg"),
                             **CPU)
    assert got == _jax_table(str(fa), cfg) and grown


@pytest.mark.parametrize("rows", [None, "512"])
def test_devmerge_crash_between_drains(tmp_path, monkeypatch, rows):
    """A crash after merging batches (and, at a fixed tiny capacity,
    after drains that appended bytes) but before a commit: the manifest
    still points at the start, the resume truncates the appends and
    counts those batches once."""
    fa = tmp_path / "sdc.fasta"
    fa.write_text(random_reads_fasta(21, 64, seed=14))
    cfg = KmerConfig(k=15, batch_reads=4, max_read_len=64, partitions=2,
                     device_merge="on")
    if rows:
        monkeypatch.setenv("KMER_TPU_DEVMERGE_ROWS", rows)
    d = tmp_path / "dm"
    sc = StreamingCounter(str(fa), cfg, str(d), **CPU)
    route = streaming._DeviceMergePass(sc)
    codes, offsets = tf.parse_seqs(str(fa))
    for i, (_, out) in enumerate(tcount.dispatch_batches(
            codes, offsets, cfg, sc.dev, route.step, sc.log)):
        route.add(i, out)
        if i == 3:
            break
    appended = sum(p.stat().st_size for p in d.glob("part_*.bin"))
    assert bool(appended) == bool(rows)
    del sc, route                      # crash: the device table is gone
    sc2 = StreamingCounter(str(fa), cfg, str(d), **CPU)
    assert sc2.state["pass1_next_batch"] == 0
    assert sc2.state["part_bytes"] == [0, 0]
    sc2.run()
    assert sc2.final_table() == _jax_table(str(fa), cfg)


def test_devmerge_reset_then_group_larger_than_state(tmp_path, monkeypatch):
    """At a fixed capacity, a chunk of short reads sizes the state, the
    commit drains and resets it, and the next chunk's wider rows bring a
    group larger than the state: DeviceMerge grows it first.  Held
    against the independent oracle (kmer_tpu's streaming drops keys
    here)."""
    rng = np.random.default_rng(5)
    seqs = (["".join(rng.choice(list("ACGT"), 40)) for _ in range(30)]
            + ["".join(rng.choice(list("ACGT"), 300)) for _ in range(30)])
    fa = tmp_path / "grow.fasta"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    cfg = KmerConfig(k=11, batch_reads=4, max_read_len=320, partitions=3,
                     device_merge="on", ingest_chunk_bases=1200)
    monkeypatch.setenv("KMER_TPU_DEVMERGE_ROWS", "64")
    caps = []
    orig = tcount.DeviceMerge.flush

    def flush(self):
        caps.append((self.capacity, self.pend_lanes))
        orig(self)
    monkeypatch.setattr(tcount.DeviceMerge, "flush", flush)
    got = stream_count_fasta(str(fa), cfg, spill_dir=str(tmp_path / "sp"),
                             **CPU)
    assert got.to_dict() == dict(oracle.oracle_count(seqs, 11))
    assert any(0 < c < n for c, n in caps)       # a group beyond the state


# ------------------------------------------------------- ingest cursors

@pytest.mark.parametrize("kind", ["plain", "gzip", "bgzf", "fastq"])
def test_start_cursor_equals_kmer_tpu(tmp_path, kind):
    from kmer_tpu.io.generator import random_reads_fastq
    text = (random_reads_fastq(40, 90, seed=3) if kind == "fastq"
            else random_reads_fasta(60, 90, seed=3))
    p = tmp_path / f"c.{kind}"
    if kind == "gzip":
        p.write_bytes(gzip.compress(text.encode()))
    elif kind == "bgzf":
        write_bgzf(str(p), text, block=1024)
    else:
        p.write_text(text)
    kw = dict(max_bases=1000)
    cursors = [0] + [c for *_, c in tf.iter_parse_chunks(str(p), **kw)]
    assert len(cursors) > 3
    for c in cursors:
        want = list(jf.iter_parse_chunks(str(p), start_cursor=c, **kw))
        got = list(tf.iter_parse_chunks(str(p), start_cursor=c, **kw))
        assert len(got) == len(want)
        for (gc, go, gcur), (wc, wo, wcur) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(go, wo)
            assert gcur == wcur


@pytest.mark.parametrize("start", [0, 1, 3, 7, 8, 9])
def test_iter_batches_start_batch_equals_kmer_tpu(sample_fasta_path, start):
    codes, offsets = jf.parse_seqs(sample_fasta_path)
    kw = dict(batch_reads=7, max_len=64, overlap=20, start_batch=start)
    want = list(jf.iter_batches(codes, offsets, **kw))
    got = list(tf.iter_batches(codes, offsets, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.start_limits, w.start_limits)
    n = len(list(tf.iter_batches(codes, offsets, batch_reads=7, max_len=64,
                                 overlap=20)))
    assert len(got) == max(n - start, 0)


def test_iter_chunks_cursors(corpus):
    cfg = KmerConfig(k=11, ingest_chunk_bases=700)
    chunks = list(tcount.iter_chunks([corpus["r60"]], cfg, cursors=True))
    cur = chunks[1][2]
    rest = list(tcount.iter_chunks([corpus["r60"]], cfg, start_cursor=cur,
                                   cursors=True))
    assert [c for *_, c in rest] == [c for *_, c in chunks[2:]]
    with pytest.raises(ValueError, match="chunked ingest"):
        list(tcount.iter_chunks([corpus["r60"]], cfg.replace(
            ingest_chunk_bases=0), start_cursor=cur))


# ----------------------------------------------------------------- CLI

def _cli_both(capsys, args, jax_extra=(), port_extra=()):
    """(kmer_tpu's stdout, the port's stdout) of one command line, each
    with its own extra arguments (a spill directory each)."""
    assert jax_main(list(args) + list(jax_extra)) == 0
    want = capsys.readouterr().out
    assert port_main(list(args) + list(port_extra) + ["--device", "cpu"]) == 0
    return want, capsys.readouterr().out


def test_cli_count_two_pass_bytes(corpus, tmp_path, capsys):
    """`python -m kmer_tpu_torch count --two-pass` prints what kmer_tpu
    prints, and what its own in-memory count prints."""
    args = ["count", corpus["g40"], "-k", "15", "--canonical",
            "--batch-reads", "16", "--max-read-len", "96"]
    two_pass = ["--two-pass", "--partitions", "4", "--spill-dir"]
    assert jax_main(args + two_pass + [str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out
    for extra in (two_pass + [str(tmp_path / "t")], []):
        res = subprocess.run(
            [sys.executable, "-m", "kmer_tpu_torch", *args, *extra,
             "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout == want and want.count("\n") > 500


def test_cli_two_pass_min_count_and_npz(tmp_path, capsys):
    p = tmp_path / "a.fasta"
    p.write_text(reference_style_fasta(n_records=4, seed=3))
    args = ["count", str(p), "-k", "9", "--batch-reads", "8",
            "--max-read-len", "512", "--two-pass", "--min-count", "3"]
    want, got = _cli_both(
        capsys, args, ["--spill-dir", str(tmp_path / "j")],
        ["--spill-dir", str(tmp_path / "t"), "--out-npz",
         str(tmp_path / "t.npz")])
    assert got == want and all(int(ln.split("\t")[1]) >= 3
                               for ln in got.splitlines())
    t = KmerTable.load(str(tmp_path / "t.npz"))
    assert len(t.counts) == got.count("\n") > 10 and all(t.counts >= 3)


@pytest.mark.parametrize("extra", [
    ["--canonical"], ["--canonical", "--two-pass", "--partitions", "4"],
    ["--gapped", "--c-min", "30", "--c-max", "40", "--l-len", "12",
     "--r-len", "13"],
    ["--gapped", "--c-min", "30", "--c-max", "40", "--l-len", "12",
     "--r-len", "13", "--two-pass", "--device-merge", "on"]])
def test_cli_histo_bytes(corpus, tmp_path, capsys, extra):
    """histo in memory and --two-pass against kmer_tpu's, and the two
    against each other."""
    args = ["histo", corpus["g40"], "-k", "15", "--batch-reads", "16",
            "--max-read-len", "96"] + extra
    spill = ["--spill-dir"] if "--two-pass" in extra else []
    want, got = _cli_both(capsys, args, spill and spill + [
        str(tmp_path / "j")], spill and spill + [str(tmp_path / "t")])
    assert got == want and got.count("\n") > 3
    if spill:
        in_memory = [a for a in args if a not in ("--two-pass",
                                                  "--partitions", "4")]
        assert port_main(in_memory + ["--device", "cpu"]) == 0
        assert capsys.readouterr().out == got


@pytest.mark.parametrize("cmd", ["count", "histo"])
@pytest.mark.parametrize("extra,msg", [
    (["--compact", "--spill-dir", "x"], "--compact applies"),
    ([], "requires --spill-dir"),
    (["--spill-dir", "x"], "exactly one input file")])
def test_cli_two_pass_errors(corpus, capsys, cmd, extra, msg):
    files = [corpus["r60"]] * (2 if "exactly" in msg else 1)
    args = [cmd, *files, "--two-pass"] + extra
    assert port_main(args + ["--device", "cpu"]) == 1
    assert msg in capsys.readouterr().err
    assert jax_main(args) == 1
    assert msg in capsys.readouterr().err


def test_exports():
    assert kmer_tpu_torch.StreamingCounter is StreamingCounter
    assert "stream_count_fasta" in kmer_tpu_torch.__all__
