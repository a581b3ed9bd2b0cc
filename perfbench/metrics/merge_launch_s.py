"""Seconds a job's calling thread spent in the `dispatch.merge` stage
(utils/stagetime): DeviceMerge.flush's concatenation of the pending lanes
and merge_batch's launches, inside `dispatch`, per job of the traced
window."""

from perfbench.spans import stage_if_present

PROBES = ["stages"]


def read(record):
    return stage_if_present(record, "dispatch.merge")
