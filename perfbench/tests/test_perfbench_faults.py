"""A whole run, the look for a card skipped (the program's plain versions
on the CPU, a small corpus), with the timed path broken underneath:
`correct` has to come out false for each fault the cells can have.  The
cells run on one card, so no exchange between cards can be left out."""

import pytest

from perfbench import harness
from perfbench.spec import BENCH_FILE, read_json

CELLS = [w["name"] for w in read_json(BENCH_FILE)["workloads"]]


def run(cell, seed=2**31 + 17):
    return harness.run_cell(cell, seed, 0.0, False)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small_on_cpu):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "compared"
    assert res["compared"]["mismatched_rows"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == {"kmers_per_s", "setup_s"}


def _state_unchanged(state_words, state_counts, *a, **kw):
    return state_words, state_counts, (state_counts > 0).sum()


def _half_batch(orig):
    def merge(state_words, state_counts, batch_words, batch_counts, *a,
              **kw):
        half = batch_counts.numel() // 2
        return orig(state_words, state_counts,
                    [w.reshape(-1)[:half] for w in batch_words],
                    batch_counts.reshape(-1)[:half], *a, **kw)
    return merge


def _altered(orig):
    def fetch(*a, **kw):
        got = orig(*a, **kw)
        if got is not None and len(got[1]):
            got[1][len(got[1]) // 2] += 1
        return got
    return fetch


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(cell, fault, small_on_cpu, monkeypatch):
    from kmer_tpu_torch.ops import devmerge
    if fault == "state_unchanged":
        monkeypatch.setattr(devmerge, "merge_batch", _state_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(devmerge, "merge_batch",
                            _half_batch(devmerge.merge_batch))
    else:
        monkeypatch.setattr(devmerge, "fetch_state_wire",
                            _altered(devmerge.fetch_state_wire))
        monkeypatch.setattr(devmerge, "fetch_state",
                            _altered(devmerge.fetch_state))
    res = run(cell)
    assert not res["correct"]
    assert res["compared"]["mismatched_rows"]["value"] > 0


def test_a_failing_job_is_counted(small_on_cpu, monkeypatch):
    from kmer_tpu_torch.ops import devmerge
    calls = {"n": 0}
    orig = devmerge.merge_batch

    def fail_after_warmup(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("injected")
        return orig(*a, **kw)
    monkeypatch.setattr(devmerge, "merge_batch", fail_after_warmup)
    res = run("k21-ecoli30x")
    assert res["failed"] == 1 and not res["correct"]


def test_traced_run_reports_per_layer_metrics(small_on_cpu):
    from kmer_tpu_torch.ops import devmerge
    from kmer_tpu_torch.pipeline import count
    from kmer_tpu_torch.utils import stagetime
    before = [devmerge.merge_batch, devmerge.sort_words,
              count.fused_extract_count, count.unfuse_words,
              stagetime.stage]
    res = harness.run_cell("k21-ecoli30x", 5, 0.0, True)
    assert res["correct"]
    # the CPU has no device trace, peak or roofline: those are left out
    assert set(res["metrics"]) == {"ingest_s", "batch_prep_s",
                                   "dispatch_s", "device_sync_s", "drain_s",
                                   "convert_s"}
    assert res["device"]["busy_s"] == 0
    assert res["metrics"]["convert_s"]["value"] > 0
    # the probes are taken out once the window has closed
    assert before == [devmerge.merge_batch, devmerge.sort_words,
                      count.fused_extract_count, count.unfuse_words,
                      stagetime.stage]
