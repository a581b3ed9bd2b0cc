"""What the metric readers under metrics/ share.  A reader's `read(record)`
takes the run's record (see harness.run_cell) and returns the metric's
value, or None where the run has nothing to read: the metric is then
left out of the result."""

from __future__ import annotations

from perfbench import tracing
from perfbench.roofline import least_seconds


def stage_per_job(record: dict, *names: str) -> float | None:
    """Seconds the caller's thread was blocked in the named stages of the
    program's stagetime, summed, per job of the traced window."""
    stages, jobs = record.get("stages"), record.get("jobs")
    if stages is None or not jobs:
        return None
    return sum(stages.get(n, 0.0) for n in names) / len(jobs)


def roofline_share(record: dict, inside: str, work) -> float | None:
    """100 x the least time of the work (a list of (bytes, operations))
    over the device time of the operations launched inside the range
    `inside`; None without a trace, a peak, work or device time."""
    trace, peak = record.get("trace"), record.get("peak")
    if trace is None or peak is None or not work:
        return None
    busy = tracing.device_seconds(trace, inside)
    if busy <= 0:
        return None
    return 100.0 * sum(least_seconds(b, o, peak) for b, o in work) / busy
