"""The port's spans and counters: per-stage wall time, profiler ranges at
the layer boundaries, and event counts.

The end-to-end wall of a corpus run is the sum of host stages (ingest,
batch prep, host merge) and device stages (dispatch, readback) that the
pipeline deliberately overlaps — a single wall number cannot say which
stage is the bottleneck.  The pipeline marks its sections, and three
independent readers can consult them:

    from kmer_tpu_torch.utils import stagetime
    times: dict[str, float] = {}
    with stagetime.collect(times):
        table = count_fasta(path, cfg)
    # times = {"ingest": ..., "dispatch": ..., "dispatch.h2d": ...,
    #          "readback": ..., "convert": ..., "total": ...}

- a stage collector (`collect`): the seconds of each `stage`;
- torch.profiler: while a profiler records, `stage(name)` and
  `stage_iter(name, it)` also open a `stage::<name>` range, and
  `span(name)` opens a range `name` (the kernels' `op::` boundaries),
  on the clock of the device operations they launch (so
  `count --profile-dir` names the layers);
- a counter collector (`counting`): the sums of `count(name, n)`.

With no collector and no profiler (the normal production case) a stage
costs one thread-local read and one flag read: no clock is read and no
range is opened.  A span costs the flag read, a count the thread-local
read.

Child stages are named `parent.child` (`dispatch.h2d`, `readback.copy`)
and nest inside their parent's `with`, so a child's seconds are part of
its parent's: the parent's seconds are what they would be without the
children, and a parent's children need not cover it.

Because the pipeline overlaps stages across threads (prefetched ingest,
background flush merges), per-stage seconds are WALL TIME SPENT BLOCKED
in that section on the calling thread: overlapped background work that
never blocks the caller correctly attributes ~0 s.  Top-level stages
therefore sum to ~total (the caller's own wall), not to the sum of all
threads' busy time.  The collectors are per thread; torch.profiler
records the ranges of the thread that started it, not those of a raw
threading.Thread such as the prefetch parser's.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_tls = threading.local()
_NO_RANGE = contextlib.nullcontext()


def active() -> dict | None:
    """The innermost active collector dict of this thread (or None)."""
    return getattr(_tls, "acc", None)


def _profiling() -> bool:
    """Whether a torch.profiler records (one flag read)."""
    return _profiler._is_profiler_enabled


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
def _section(acc: dict | None, ranged: bool, name: str):
    with record_function(f"stage::{name}") if ranged else _NO_RANGE:
        if acc is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0


def stage(name: str):
    """Accumulate the block's wall time under `name` in the active
    collector, inside a `stage::<name>` range while a profiler records;
    a no-op with neither."""
    acc = active()
    ranged = _profiling()
    if acc is None and not ranged:
        return _NO_RANGE
    return _section(acc, ranged, name)


def stage_iter(name: str, it):
    """Wrap an iterator so the time the CONSUMER spends blocked in
    next() is accumulated under `name` (e.g. waiting on the prefetched
    native parser when ingest falls behind the device), each next()
    inside a `stage::<name>` range while a profiler records."""
    acc = active()
    ranged = _profiling()
    if acc is None and not ranged:
        yield from it
        return
    it = iter(it)
    while True:
        with _section(acc, ranged, name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def span(name: str):
    """A profiler range `name` around the block while a profiler records
    (no seconds are kept); a no-op otherwise."""
    return record_function(name) if _profiling() else _NO_RANGE


@contextlib.contextmanager
def counting(out: dict):
    """Activate `out` as this thread's counter collector: count() adds
    to it.  Independent of collect()."""
    prev = getattr(_tls, "counts", None)
    _tls.counts = out
    try:
        yield out
    finally:
        _tls.counts = prev


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the active counter collector; a
    no-op without one."""
    out = getattr(_tls, "counts", None)
    if out is not None:
        out[name] = out.get(name, 0) + n
