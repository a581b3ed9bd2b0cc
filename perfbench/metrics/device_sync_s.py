"""Seconds a job's calling thread was blocked in the program's
`device_sync` stage (utils/stagetime), per job of the traced window."""

from perfbench.readers import stage_per_job

PROBES = ["stages"]


def read(record):
    return stage_per_job(record, "device_sync")
