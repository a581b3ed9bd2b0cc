"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result.

Set-up builds (in a fresh checkout) or loads the program's libraries,
writes the cell's corpus from the seed under TMPDIR and runs one job.
The window runs jobs back to back, one client in a closed loop, until
the clock passes the run's seconds; every job started is finished.  With
`trace`, the window runs under torch.profiler with the probes (probes/)
that the cell's per-layer metrics name in their readers' PROBES, and
the result holds the per-layer metrics instead of the end-to-end ones.  Once the window has closed, every job's output is
compared with the reference.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time

from perfbench import card, tracing
from perfbench.roofline.peaks import peak_of
from perfbench.spec import Spec

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "kmer_tpu")
NoCard = card.NoCard


def loaded_forbidden() -> list[str]:
    """FORBIDDEN names among the loaded modules' top-level names, each
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _window(entry, path, cfg, seconds: float,
            around=contextlib.nullcontext):
    """Jobs back to back until `seconds` have passed, each inside
    `around()`: (tables, jobs, errors, window seconds)."""
    tables, jobs, errors = [], [], []
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            with around():
                tables.append(entry.run(path, cfg, card.DEVICE))
            ok = True
        except Exception as exc:        # a failed job is counted, and ends
            errors.append(repr(exc))    # the window
            ok = False
        t1 = time.perf_counter()
        jobs.append({"start": t0 - w0, "end": t1 - w0, "ok": ok})
        if not ok or t1 - w0 >= seconds:
            break
    card.sync()
    return tables, jobs, errors, time.perf_counter() - w0


def _traced_window(entry, path, cfg, seconds: float, probes: list,
                   tmp: str, log) -> tuple:
    """_window under torch.profiler with the named probes (probes/) in
    place: its (tables, jobs, errors, window seconds) and the trace's
    and probes' part of the record."""
    from torch.profiler import profile, record_function
    undo = []

    def patch(mod, name, fn) -> None:
        undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    try:
        with profile(activities=card.activities()) as prof, \
                contextlib.ExitStack() as stack:
            counters = [stack.enter_context(Spec.probe(name).probe(patch))
                        for name in probes]
            with record_function("bench::window"):
                out = _window(entry, path, cfg, seconds,
                              lambda: record_function("bench::job"))
    finally:
        while undo:
            mod, name, fn = undo.pop()
            setattr(mod, name, fn)
    t0 = time.perf_counter()
    trace_path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(trace_path)
    size = os.path.getsize(trace_path)
    trace = tracing.load_trace(trace_path)
    os.unlink(trace_path)
    print(f"trace_bytes={size} trace_read_s={time.perf_counter() - t0}",
          file=log, flush=True)
    record = {"trace": trace, "activity": tracing.window_activity(trace)}
    for read in counters:
        record.update(read())
    return out, record


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float | None = None) -> dict:
    """Run `workload` once; returns the result line's object.  Raises
    NoCard where the cell's cards are missing."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(workload)
    log = sys.stderr
    chips = spec.cell["chips"]
    card.require(chips)
    entry, fields = spec.entry(), spec.config["kmer_config"]
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in spec.metrics(kind)}
    readers = {name: spec.reader(name) for name in units}
    probes = sorted({p for r in readers.values()
                     for p in getattr(r, "PROBES", ())})
    marks = {"imports": time.perf_counter() - t_start}
    info = card.open_card(entry.LIBRARIES)
    marks["card"] = time.perf_counter() - t_start
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        path = os.path.join(tmp, "corpus")
        lengths = spec.generator().write(path, spec.traffic["params"], seed,
                                         card.DEVICE)
        card.free()
        marks["corpus"] = time.perf_counter() - t_start
        work = entry.work(fields, lengths)
        cfg = entry.make(fields)
        entry.run(path, cfg, card.DEVICE)                  # warm-up job
        card.sync()
        setup_s = time.perf_counter() - t_start
        print(f"setup_s={setup_s} "
              + " ".join(f"{k}_done_s={v:.3f}" for k, v in marks.items())
              + f" corpus_bytes={os.path.getsize(path)} reads={len(lengths)}"
              f" kmers_a_job={work} card={info['name']}"
              f" power_limit={info['power_limit']}", file=log, flush=True)

        card.reset_peak()
        record = {"setup_s": setup_s, "work_per_job": work,
                  "peak": peak_of(info["name"])}
        if trace:
            (tables, jobs, errors, window_s), traced = _traced_window(
                entry, path, cfg, seconds, probes, tmp, log)
            record.update(traced)
        else:
            tables, jobs, errors, window_s = _window(entry, path, cfg,
                                                     seconds)
        peak = card.peak_bytes()
        record.update(jobs=jobs, window_s=window_s, peak_mem_bytes=peak)
        for e in errors:
            print(f"job failed: {e}", file=log, flush=True)

        card.free()
        t_check = time.perf_counter()
        compared = entry.check(tables, path, fields, lengths, card.DEVICE)
        print(f"jobs={len(jobs)} window_s={window_s} check_s="
              f"{time.perf_counter() - t_check} distinct="
              f"{tables[0].num_distinct if tables else None} job_s="
              + ",".join(f"{j['end'] - j['start']:.4f}" for j in jobs),
              file=log, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    for name, reader in readers.items():
        value = reader.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    failed = sum(not j["ok"] for j in jobs)
    result = {
        "correct": failed == 0 and all(v <= lim for _, v, lim in compared),
        "attempted": len(jobs), "failed": failed, "metrics": metrics,
        "device": {"platform": card.PLATFORM, "kind": info["name"],
                   "count": chips, "memory_peak_bytes": peak}}
    if trace and record.get("activity"):
        result["device"]["busy_s"] = record["activity"]["busy_s"]
        result["device"]["window_s"] = record["activity"]["window_s"]
        result["breakdown"] = {
            "device_ops": tracing.top_ops(record["trace"]),
            "idle_gaps": tracing.top_gaps(record["activity"])}
    result["card"] = info
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result
