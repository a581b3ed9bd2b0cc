"""Seconds a job's calling thread spent in the `dispatch.step` stage
(utils/stagetime): the count step's launches (K1) on each batch, inside
`dispatch`, per job of the traced window."""

from perfbench.spans import stage_if_present

PROBES = ["stages"]


def read(record):
    return stage_if_present(record, "dispatch.step")
