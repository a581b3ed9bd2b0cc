"""The port's spans and counters (kmer_tpu_torch/utils/stagetime), on the
CPU: stage seconds, nesting and consumer waits; no clock and no range
with neither a collector nor a profiler; the `stage::` ranges in a CPU
profiler's trace; DeviceMerge's counters against the merges it made; the
table unchanged by tracing; and `count --stats`'s `done` line."""

import io
import json
import time
import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import kmer_tpu_torch
from kmer_tpu_torch.io.generator import genome_reads_fasta
from kmer_tpu_torch.ops import devmerge
from kmer_tpu_torch.pipeline import count as tcount
from kmer_tpu_torch.utils import stagetime
from kmer_tpu_torch.utils.stats import StatsLogger

# batches of 64 reads: the device merge takes several merges and a grow
# of its state before its one drain
CFG = dict(k=21, canonical=True, device_merge="on", batch_reads=64,
           max_read_len=160)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    p = tmp_path_factory.mktemp("stagetime") / "reads.fasta"
    p.write_text(genome_reads_fasta(1500, 150, genome_len=60_000, seed=5))
    return str(p)


def test_stage_accumulates_and_nests():
    out = {}
    with stagetime.collect(out):
        with stagetime.stage("a"):
            with stagetime.stage("a.x"):
                time.sleep(0.01)
            with stagetime.stage("a.y"):
                time.sleep(0.005)
        with stagetime.stage("a"):
            pass
        with stagetime.stage("b"):
            pass
    assert out["a.x"] >= 0.01 and out["a.y"] >= 0.005
    assert out["a"] >= out["a.x"] + out["a.y"]
    assert "b" in out and out["total"] >= out["a"] + out["b"]
    with stagetime.stage("c"):          # no collector: no key, no error
        pass
    assert "c" not in out


def test_stage_iter_attributes_consumer_wait():
    def slow():
        for i in range(3):
            time.sleep(0.005)
            yield i
    out = {}
    with stagetime.collect(out):
        assert list(stagetime.stage_iter("ing", slow())) == [0, 1, 2]
    assert out["ing"] >= 0.015
    assert list(stagetime.stage_iter("ing", iter([7]))) == [7]


def test_idle_stage_reads_no_clock_and_opens_no_range(monkeypatch):
    """With neither a collector nor a profiler a stage, a stage_iter and
    a span read no clock and open no range; a count adds nothing."""
    calls = []

    def no_clock():
        calls.append("clock")
        return 0.0

    def no_range(name):
        calls.append(name)
        raise AssertionError("a range was opened")
    monkeypatch.setattr(stagetime, "time",
                        types.SimpleNamespace(perf_counter=no_clock))
    monkeypatch.setattr(stagetime, "record_function", no_range)
    with stagetime.stage("dispatch"), stagetime.stage("dispatch.h2d"):
        pass
    assert list(stagetime.stage_iter("ingest", [1, 2])) == [1, 2]
    with stagetime.span("op::K1"):
        pass
    stagetime.count("devmerge.merges", 3)
    assert calls == []


def test_counting_is_independent_of_collect():
    seconds, counts = {}, {}
    with stagetime.collect(seconds), stagetime.counting(counts):
        stagetime.count("a")
        stagetime.count("a", 4)
        with stagetime.counting({}) as inner:
            stagetime.count("b", 2)
        with stagetime.stage("s"):
            stagetime.count("c")
    assert counts == {"a": 5, "c": 1} and inner == {"b": 2}
    assert set(seconds) == {"s", "total"}


def _ranges(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"]


def test_profiler_ranges_nest(reads, tmp_path):
    """Under a CPU profiler and no collector, a count's stages open
    `stage::` ranges, each child inside its parent, and merge_batch an
    `op::merge_batch` range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kmer_tpu_torch.count_fasta(reads, device="cpu", **CFG)
    ranges = _ranges(prof, tmp_path)
    names = {n for n, _, _ in ranges}
    assert {"stage::ingest", "stage::batch_prep", "stage::dispatch",
            "stage::dispatch.h2d", "stage::dispatch.step",
            "stage::dispatch.merge", "stage::readback",
            "stage::readback.encode", "stage::readback.copy",
            "stage::readback.decode", "stage::convert",
            "op::merge_batch"} <= names, sorted(names)
    for child, parent in (("dispatch.h2d", "dispatch"),
                          ("dispatch.step", "dispatch"),
                          ("dispatch.merge", "dispatch"),
                          ("readback.decode", "readback")):
        outer = [(a, b) for n, a, b in ranges if n == f"stage::{parent}"]
        for n, a, b in ranges:
            if n == f"stage::{child}":
                assert any(a0 <= a and b <= b0 for a0, b0 in outer), child


def test_merge_reduce_range_inside_merge_batch(reads, tmp_path):
    """Each merge's run totals and compaction open an `op::merge_reduce`
    range inside its `op::merge_batch` range, one a merge, after K6's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kmer_tpu_torch.count_fasta(reads, device="cpu", **CFG)
    ranges = _ranges(prof, tmp_path)
    merges = [(a, b) for n, a, b in ranges if n == "op::merge_batch"]
    reduces = [(a, b) for n, a, b in ranges if n == "op::merge_reduce"]
    sorts = [(a, b) for n, a, b in ranges if n == "op::K6"]
    assert len(merges) == len(reduces) > 1
    for a, b in reduces:
        assert sum(a0 <= a and b <= b0 for a0, b0 in merges) == 1
        assert any(a0 <= s0 and s1 <= a for a0, b0 in merges
                   if a0 <= a and b <= b0 for s0, s1 in sorts)


def test_devmerge_counters_match_the_merges(reads, monkeypatch):
    """The devmerge.* counters a count hands to stagetime equal the state
    rows C and lanes N that every merge_batch call was given."""
    seen = []
    merge0 = devmerge.merge_batch

    def merge_batch(state_words, state_counts, batch_words, batch_counts,
                    *a, **kw):
        seen.append((state_counts.numel(), batch_counts.numel()))
        return merge0(state_words, state_counts, batch_words, batch_counts,
                      *a, **kw)
    monkeypatch.setattr(devmerge, "merge_batch", merge_batch)
    counts = {}
    with stagetime.counting(counts):
        table = kmer_tpu_torch.count_fasta(reads, device="cpu", **CFG)
    assert len(seen) > 2
    assert counts["devmerge.merges"] == len(seen)
    assert counts["devmerge.lanes"] == sum(n for _, n in seen)
    assert counts["devmerge.rows_sorted"] == sum(c + n for c, n in seen)
    assert counts["devmerge.grows"] >= 1
    assert counts["devmerge.drains"] >= 1
    assert counts["devmerge.rows_drained"] == table.num_distinct
    # the plain twin on the CPU: no merge ran the kernel
    assert counts["devmerge.reduced_on_card"] == 0


def test_tracing_leaves_the_table_unchanged(reads, tmp_path):
    plain = kmer_tpu_torch.count_fasta(reads, device="cpu", **CFG)
    seconds, counts = {}, {}
    with profile(activities=[ProfilerActivity.CPU]), \
            stagetime.collect(seconds), stagetime.counting(counts):
        traced = kmer_tpu_torch.count_fasta(reads, device="cpu", **CFG)
    assert traced.k == plain.k
    assert np.asarray(traced.keys).tobytes() == np.asarray(
        plain.keys).tobytes()
    assert np.asarray(traced.counts).tobytes() == np.asarray(
        plain.counts).tobytes()
    assert seconds["dispatch"] >= (seconds["dispatch.h2d"]
                                   + seconds["dispatch.step"]
                                   + seconds["dispatch.merge"])
    assert seconds["readback"] >= seconds["readback.decode"]
    assert counts["devmerge.merges"] > 0


def test_stats_done_line_carries_devmerge_counters(reads):
    """`count --stats`'s `done` line holds the DeviceMerge's counters
    when the device merge ran, and each batch has its line."""
    from kmer_tpu_torch.config import KmerConfig
    from kmer_tpu_torch.io.fasta import parse_seqs
    codes, offsets = parse_seqs(reads)
    stream = io.StringIO()
    counts = {}
    with stagetime.counting(counts):
        table = tcount.count_codes(codes, offsets, KmerConfig(**CFG),
                                   stats=StatsLogger(stream), device="cpu")
    lines = [json.loads(x) for x in stream.getvalue().splitlines()]
    done = [x for x in lines if x["event"] == "done"]
    assert len(done) == 1 and done[0]["distinct"] == table.num_distinct
    assert done[0]["devmerge"] == {name[len("devmerge."):]: n
                                   for name, n in counts.items()}
    assert set(done[0]["devmerge"]) == {"merges", "lanes", "rows_sorted",
                                        "grows", "drains", "rows_drained",
                                        "reduced_on_card"}
    batches = [x for x in lines if x["event"] == "batch"]
    assert len(batches) == done[0]["batches"] > 1
    assert all(x["reads"] > 0 and x["secs"] >= 0 for x in batches)
