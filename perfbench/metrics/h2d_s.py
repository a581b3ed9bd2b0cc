"""Seconds a job's calling thread spent in the `dispatch.h2d` stage
(utils/stagetime): the copies of each batch to the card, inside
`dispatch`, per job of the traced window."""

from perfbench.spans import stage_if_present

PROBES = ["stages"]


def read(record):
    return stage_if_present(record, "dispatch.h2d")
