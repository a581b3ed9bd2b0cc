"""The reading of the profiler's trace of a traced run.

The probes (probes/) open ranges at the program's layer boundaries;
`read_trace` turns the profiler's Chrome trace into device operations,
each with the names of the ranges open on the host thread that launched
it, and the ranges themselves.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 96


def _paths(ranges: list, points: list) -> list:
    """For each (tid, ts) point, the names of the ranges of that thread
    open at ts, innermost first.  ranges: (name, tid, start, end)."""
    by_tid: dict = {}
    for r in ranges:
        by_tid.setdefault(r[1], []).append(r)
    out = [()] * len(points)
    order = sorted(range(len(points)), key=lambda i: points[i])
    cursor = {tid: 0 for tid in by_tid}
    stacks: dict = {tid: [] for tid in by_tid}
    for tid in by_tid:
        by_tid[tid].sort(key=lambda r: (r[2], -r[3]))
    for i in order:
        tid, ts = points[i]
        rs = by_tid.get(tid)
        if rs is None:
            continue
        stack = stacks[tid]
        j = cursor[tid]
        while j < len(rs) and rs[j][2] <= ts:
            while stack and stack[-1][3] <= rs[j][2]:
                stack.pop()
            stack.append(rs[j])
            j += 1
        cursor[tid] = j
        while stack and stack[-1][3] <= ts:
            stack.pop()
        out[i] = tuple(r[0] for r in reversed(stack))
    return out


def read_trace(events: list) -> dict:
    """Chrome trace events -> {"ranges": [(name, tid, start_s, end_s)],
    "device": [(name, cat, start_s, end_s, path)]}: every user range, and
    every device operation with the names of the ranges open where it was
    launched (innermost first; () where no launch is found).  Times in
    seconds on the trace's clock."""
    ranges, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        t0, t1 = e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6
        if cat == "user_annotation":
            ranges.append((e["name"], e["tid"], t0, t1))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], t0)
        elif cat in DEVICE_CATS:
            device.append((e["name"], cat, t0, t1,
                           e.get("args", {}).get("correlation")))
    found = [launches.get(d[4]) for d in device]
    paths = _paths(ranges, [f for f in found if f is not None])
    it = iter(paths)
    device = [(n, c, t0, t1, next(it) if f is not None else ())
              for (n, c, t0, t1, _), f in zip(device, found)]
    return {"ranges": ranges, "device": device}


def load_trace(path: str) -> dict:
    with open(path) as f:
        return read_trace(json.load(f)["traceEvents"])


def _label(path: tuple) -> str:
    """The innermost `stage::` range of a path, else its innermost range."""
    return next((n for n in path if n.startswith("stage::")),
                path[0] if path else "none")


def window_activity(trace: dict, window: str = "bench::window") -> dict:
    """Busy and idle time of the device inside the named range: its
    length, the union of device operations within it, and the idle time
    split by what the range's thread was in (`_label`), as (label,
    seconds) pieces."""
    win = [r for r in trace["ranges"] if r[0] == window]
    if not win:
        return {}
    _, tid, w0, w1 = win[0]
    spans = sorted((max(t0, w0), min(t1, w1))
                   for _, _, t0, t1, _ in trace["device"]
                   if t1 > w0 and t0 < w1)
    busy, gaps, cur = 0.0, [], w0
    for t0, t1 in spans:
        if t0 > cur:
            gaps.append((cur, t0))
        if t1 > cur:
            busy += t1 - max(t0, cur)
            cur = t1
    if w1 > cur:
        gaps.append((cur, w1))
    # the thread's ranges cut the window into pieces of one label each
    cuts = sorted({w0, w1} | {t for r in trace["ranges"] if r[1] == tid
                              for t in r[2:] if w0 < t < w1})
    pieces = list(zip(cuts[:-1], cuts[1:]))
    labels = [_label(p) for p in _paths(trace["ranges"],
                                        [(tid, (a + b) / 2)
                                         for a, b in pieces])]
    idle, j = [], 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        i = j
        while i < len(pieces) and pieces[i][0] < g1:
            overlap = min(g1, pieces[i][1]) - max(g0, pieces[i][0])
            if overlap > 0:
                idle.append((labels[i], overlap))
            i += 1
    return {"window_s": w1 - w0, "busy_s": busy, "gaps": idle}


def device_seconds(trace: dict, inside: str) -> float:
    """Device time of the operations launched inside a range of that
    name."""
    return sum(t1 - t0 for _, _, t0, t1, path in trace["device"]
               if inside in path)


def top_ops(trace: dict, n: int = 10) -> list:
    """The n device operations that took most time, by name (its first
    NAME_CHARS characters)."""
    by: dict = {}
    for name, _, t0, t1, _ in trace["device"]:
        key = name[:NAME_CHARS]
        by[key] = by.get(key, 0.0) + (t1 - t0)
    return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]


def top_gaps(activity: dict, n: int = 10) -> list:
    """Idle seconds by what the launching thread was in, most first."""
    by: dict = {}
    for name, s in activity.get("gaps", []):
        by[name] = by.get(name, 0.0) + s
    return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]
