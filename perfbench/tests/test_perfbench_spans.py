"""The readers of the program's child stages and counters: each on a
synthetic record, nothing read from a program that lacks them, and a
traced CPU run that reports them, consistent with the stages they sit in
and with the merges probe's records of the same run."""

import pytest

from perfbench import harness
from perfbench.spec import Spec

NEW = ["h2d_s", "step_launch_s", "merge_launch_s", "wire_decode_s",
       "convert_stage_s", "merge_rows_per_lane"]


def record():
    return {
        "jobs": [{"ok": True}, {"ok": True}],
        "stages": {"dispatch": 3.0, "dispatch.h2d": 2.0,
                   "dispatch.step": 0.4, "dispatch.merge": 0.5,
                   "readback": 0.6, "readback.decode": 0.4, "convert": 0.5,
                   "total": 6.0},
        "counters": {"devmerge.lanes": 1000, "devmerge.rows_sorted": 3100,
                     "devmerge.merges": 4}}


@pytest.mark.parametrize("name, want", [
    ("h2d_s", 1.0), ("step_launch_s", 0.2), ("merge_launch_s", 0.25),
    ("wire_decode_s", 0.2), ("convert_stage_s", 0.25),
    ("merge_rows_per_lane", 3.1)])
def test_readers(name, want):
    assert Spec.reader(name).read(record()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_stage_or_counter_reads_nothing(name):
    older = {"jobs": [{"ok": True}], "stages": {"dispatch": 1.0,
                                                "total": 2.0}}
    assert Spec.reader(name).read(older) is None


def test_counters_probe_without_counting(monkeypatch):
    """On a program whose stagetime has no `counting` the probe yields a
    reading without `counters`."""
    from kmer_tpu_torch.utils import stagetime
    monkeypatch.delattr(stagetime, "counting", raising=False)
    with Spec.probe("counters").probe(lambda *a: None) as read:
        pass
    assert read() == {}


def test_traced_run_reports_the_child_stages(small_on_cpu, monkeypatch):
    """A traced run on the CPU reports the six metrics, the children
    within their parents, and merge_rows_per_lane equal to the merges
    probe's sum of C + N over its sum of N."""
    records = []
    reader0 = Spec.reader

    def reader(name):
        mod = reader0(name)
        if name == "merge_rows_per_lane":
            read0 = mod.read
            mod.read = lambda rec: records.append(rec) or read0(rec)
        return mod
    monkeypatch.setattr(Spec, "reader", staticmethod(reader))
    res = harness.run_cell("k21-ecoli30x", 2**31 + 99, 0.0, True)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["h2d_s"] + m["step_launch_s"] + m["merge_launch_s"] <= (
        m["dispatch_s"])
    assert 0 < m["wire_decode_s"] <= m["drain_s"]
    assert m["convert_stage_s"] > 0
    [rec] = records
    merges = rec["merges"]
    assert merges and m["merge_rows_per_lane"] == pytest.approx(
        sum(x["C"] + x["N"] for x in merges) / sum(x["N"] for x in merges))
