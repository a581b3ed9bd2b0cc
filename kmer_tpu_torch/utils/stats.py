"""Structured per-batch observability.

stdout carries the count table, so stats go to stderr (or any stream)
as JSONL — never stdout, which stays byte-exact.
"""

from __future__ import annotations

import json
import sys
import time


class StatsLogger:
    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"event": event, "t": round(time.perf_counter() - self._t0, 6)}
        rec.update(fields)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()


class Timer:
    """Context-manager wall timer."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def prefetch_iter(it, depth: int = 1):
    """Run `it` on a background thread, keeping up to `depth` items
    ready: the native chunk parser (a ctypes call — releases the GIL)
    then overlaps the consumer's device/count work.  Exceptions
    propagate at the matching yield point.  If the consumer abandons or
    closes this generator, the worker notices via a cancellation event
    (its q.put polls instead of blocking forever), closes the inner
    iterator (releasing parsed-chunk buffers and the native ingest
    handle), and exits — up to depth+1 chunks can otherwise stay pinned
    indefinitely."""
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    DONE, ERR = object(), object()
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for item in it:
                    if not put(item):
                        return            # consumer gone
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put((ERR, e))
                return
            put(DONE)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()                   # run the inner finally NOW

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is ERR:
                raise item[1]
            yield item
    finally:
        cancel.set()
