"""Seconds a job's calling thread spent in the program's own `convert`
stage (utils/stagetime): the drained rows made fused keys (`to_part`)
and the table's key words (`unfuse_words`), per job of the traced
window."""

from perfbench.spans import stage_if_present

PROBES = ["stages"]


def read(record):
    return stage_if_present(record, "convert")
