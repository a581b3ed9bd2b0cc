"""Seconds a job's calling thread was blocked reading the device merge's
table back (`readback`) and merging parts on the host (`host_merge`),
per job of the traced window."""

from perfbench.readers import stage_per_job

PROBES = ["stages"]


def read(record):
    return stage_per_job(record, "readback", "host_merge")
