"""Per-stage wall-time accounting for the counting pipeline.

The end-to-end wall of a corpus run is the sum of host stages (ingest,
batch prep, host merge) and device stages (dispatch, readback) that the
pipeline deliberately overlaps — a single wall number cannot say which
stage is the bottleneck.  This module is a zero-dependency collector
the pipeline consults at marked sections:

    from kmer_tpu_torch.utils import stagetime
    times: dict[str, float] = {}
    with stagetime.collect(times):
        table = count_fasta(path, cfg)
    # times = {"ingest": ..., "dispatch": ..., "readback": ...,
    #          "table_build": ..., "host_merge": ..., "total": ...}

When no collector is active (the normal production case) every marked
section costs one thread-local attribute read — no timers run.

Because the pipeline overlaps stages across threads (prefetched ingest,
background flush merges), per-stage seconds are WALL TIME SPENT BLOCKED
in that section on the calling thread: overlapped background work that
never blocks the caller correctly attributes ~0 s.  Stages therefore
sum to ~total (the caller's own wall), not to the sum of all threads'
busy time.
"""

from __future__ import annotations

import contextlib
import threading
import time

_tls = threading.local()


def active() -> dict | None:
    """The innermost active collector dict of this thread (or None)."""
    return getattr(_tls, "acc", None)


@contextlib.contextmanager
def collect(out: dict):
    """Activate `out` as this thread's stage collector; also accumulates
    the block's own wall time under "total"."""
    prev = getattr(_tls, "acc", None)
    _tls.acc = out
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["total"] = out.get("total", 0.0) + time.perf_counter() - t0
        _tls.acc = prev


@contextlib.contextmanager
def stage(name: str):
    """Accumulate the block's wall time under `name` (no-op without an
    active collector)."""
    acc = active()
    if acc is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0


def stage_iter(name: str, it):
    """Wrap an iterator so the time the CONSUMER spends blocked in
    next() is accumulated under `name` (e.g. waiting on the prefetched
    native parser when ingest falls behind the device)."""
    acc = active()
    if acc is None:
        yield from it
        return
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            return
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        yield item
