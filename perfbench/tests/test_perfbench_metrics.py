"""Each reader on a synthetic record; the trace reading; the rooflines
against the bounds they reproduce."""

import math

import pytest

from perfbench import tracing
from perfbench.roofline import k1, k6, least_seconds, merge
from perfbench.roofline.peaks import peak_of
from perfbench.spec import BENCH_FILE, Spec, read_json

BENCH = read_json(BENCH_FILE)

H100 = peak_of("NVIDIA H100 80GB HBM3")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


# a 100 us window: a job with an ingest stage, a dispatch stage holding
# K1 (one kernel) and a merge (K6's kernel and a scan), and a readback;
# a second thread's range must not claim the first thread's launches
EVENTS = [
    ev("user_annotation", "bench::window", 0, 100),
    ev("user_annotation", "bench::job", 0, 100),
    ev("user_annotation", "stage::ingest", 0, 10),
    ev("user_annotation", "stage::dispatch", 10, 60),
    ev("user_annotation", "bench::K1", 12, 4),
    ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
    ev("user_annotation", "bench::merge_batch", 20, 40),
    ev("user_annotation", "bench::K6", 21, 9),
    ev("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=2),
    ev("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=3),
    ev("user_annotation", "stage::readback", 80, 20),
    ev("cuda_runtime", "cudaMemcpyAsync", 81, 1, corr=4),
    ev("user_annotation", "stage::other", 0, 100, tid=2),
    ev("kernel", "fused_cut_kernel<unsigned long, 2>", 15, 5, tid=7, corr=1),
    ev("kernel", "scatter_kernel<2>", 22, 20, tid=7, corr=2),
    ev("kernel", "tensor_kernel_scan_innermost_dim", 42, 18, tid=7, corr=3),
    ev("gpu_memcpy", "Memcpy DtoH", 85, 10, tid=7, corr=4),
    ev("kernel", "orphan", 96, 2, tid=7, corr=99),
]


def test_read_trace_attributes_launches():
    tr = tracing.read_trace(EVENTS)
    paths = {d[0]: d[4] for d in tr["device"]}
    assert paths["fused_cut_kernel<unsigned long, 2>"][:2] == (
        "bench::K1", "stage::dispatch")
    assert paths["scatter_kernel<2>"][:3] == ("bench::K6",
                                             "bench::merge_batch",
                                             "stage::dispatch")
    assert paths["tensor_kernel_scan_innermost_dim"][0] == (
        "bench::merge_batch")
    assert paths["Memcpy DtoH"][0] == "stage::readback"
    assert paths["orphan"] == ()
    assert tracing.device_seconds(tr, "bench::merge_batch") == (
        pytest.approx(38e-6))
    assert tracing.device_seconds(tr, "bench::K6") == pytest.approx(20e-6)


def test_window_activity_and_gaps():
    tr = tracing.read_trace(EVENTS)
    act = tracing.window_activity(tr)
    assert act["window_s"] == pytest.approx(100e-6)
    assert act["busy_s"] == pytest.approx((5 + 38 + 10 + 2) * 1e-6)
    gaps = dict((k, v) for k, v in tracing.top_gaps(act))
    # idle: 0-15, 20-22, 60-85, 95-96, 98-100
    assert gaps["stage::ingest"] == pytest.approx(10e-6)
    assert gaps["stage::dispatch"] == pytest.approx((5 + 2 + 10) * 1e-6)
    assert gaps["bench::job"] == pytest.approx(10e-6)
    assert gaps["stage::readback"] == pytest.approx((5 + 1 + 2) * 1e-6)
    top = tracing.top_ops(tr, 2)
    assert [t[0] for t in top] == ["scatter_kernel<2>",
                                   "tensor_kernel_scan_innermost_dim"]


def record():
    return {
        "setup_s": 12.5, "work_per_job": 1000, "window_s": 4.0,
        "jobs": [{"ok": True}, {"ok": True}, {"ok": False}],
        "stages": {"ingest": 0.3, "batch_prep": 0.6, "dispatch": 3.0,
                   "device_sync": 0.9, "readback": 0.45, "host_merge": 0.15,
                   "total": 5.0},
        "trace": tracing.read_trace(EVENTS),
        "activity": tracing.window_activity(tracing.read_trace(EVENTS)),
        "convert_s": 0.81,
        "k1_launches": [[8192, 160, 140, 1, True]],
        "merges": [{"W": 1, "C": 1 << 24, "N": 1 << 23, "lane_bytes": 9,
                    "before": 1000, "after": 3000}],
        "peak_mem_bytes": 5_130_000_000, "peak": H100}


@pytest.mark.parametrize("name, want", [
    ("kmers_per_s", 2 * 1000 / 4.0),
    ("setup_s", 12.5),
    ("ingest_s", 0.1), ("batch_prep_s", 0.2), ("dispatch_s", 1.0),
    ("device_sync_s", 0.3), ("drain_s", 0.2), ("convert_s", 0.27),
    ("device_idle", 45.0),
    ("peak_mem_gb", 5.13),
])
def test_readers(name, want):
    assert Spec.reader(name).read(record()) == pytest.approx(want)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_probe_a_reader_names_has_its_file(metric):
    """A reader names the probes it needs; each is a file of probes/ with
    a `probe(patch)` that yields the reading of its counters."""
    for name in getattr(Spec.reader(metric), "PROBES", ()):
        assert callable(Spec.probe(name).probe)


def test_roofline_readers():
    rec = record()
    k1_s = least_seconds(k1.n_bytes(8192, 160, 140, 1, True),
                         k1.n_ops(8192, 140), H100)
    assert Spec.reader("k1_roofline").read(rec) == pytest.approx(
        100 * k1_s / 5e-6)
    n = (1 << 24) + (1 << 23)
    assert Spec.reader("k6_roofline").read(rec) == pytest.approx(
        100 * least_seconds(k6.n_bytes(n, 2), k6.n_ops(n, 1), H100) / 20e-6)
    m_s = least_seconds(merge.n_bytes(1, 1000, 3000, 1 << 23, 9),
                        merge.n_ops(1, 1 << 23), H100)
    assert Spec.reader("merge_roofline").read(rec) == pytest.approx(
        100 * m_s / 38e-6)


@pytest.mark.parametrize("name", ["k1_roofline", "k6_roofline",
                                  "merge_roofline", "device_idle",
                                  "ingest_s", "convert_s", "peak_mem_gb"])
def test_readers_without_anything_to_read(name):
    bare = {"jobs": [], "window_s": 1.0, "peak": None, "peak_mem_bytes": 0}
    assert Spec.reader(name).read(bare) is None


def test_no_roofline_without_a_peak():
    rec = {**record(), "peak": None}
    for name in ("k1_roofline", "k6_roofline", "merge_roofline"):
        assert Spec.reader(name).read(rec) is None


def test_k1_reproduces_its_bound():
    """PERF.md's K1 bound: 0.00320 ms at B = 8192, L = 160, k = 21 (P_pad
    140, one word, packed); two words at k = 55 (P_pad 106): 0.00452."""
    ms = 1e3 * least_seconds(k1.n_bytes(8192, 160, 140, 1, True),
                             k1.n_ops(8192, 140), H100)
    assert round(ms, 5) == 0.00320
    ms = 1e3 * least_seconds(k1.n_bytes(8192, 160, 106, 2, True),
                             k1.n_ops(8192, 106), H100)
    assert round(ms, 5) == 0.00452


def test_k6_reproduces_its_bound():
    """PERF.md's K6 bound at the k = 21 merge: 0.240 ms for 25.2 M rows
    (a 2**24-row state and 2**23 lanes) of one key word and a count; at
    k = 55 (two key words) 0.361."""
    n = (1 << 24) + (1 << 23)
    assert round(1e3 * least_seconds(k6.n_bytes(n, 2), k6.n_ops(n, 1),
                                     H100), 3) == 0.240
    assert round(1e3 * least_seconds(k6.n_bytes(n, 3), k6.n_ops(n, 2),
                                     H100), 3) == 0.361


def test_merge_counts_the_work_not_the_padding():
    # 8 M state rows live of 16 M, 4 M lanes of 9 bytes, 10 M after
    got = merge.n_bytes(1, 8 << 20, 10 << 20, 4 << 20, 9)
    assert got == 16 * (18 << 20) + 9 * (4 << 20)
    assert merge.n_ops(2, 1 << 20) == (1 << 20) * 20 * 2
    assert math.isclose(least_seconds(got, 0, H100), got / 3.35e12)
