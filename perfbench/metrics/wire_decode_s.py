"""Seconds a job's calling thread spent in the `readback.decode` stage
(utils/stagetime): the host's rebuild of the drained rows from the wire
tiers, inside `readback`, per job of the traced window."""

from perfbench.spans import stage_if_present

PROBES = ["stages"]


def read(record):
    return stage_if_present(record, "readback.decode")
