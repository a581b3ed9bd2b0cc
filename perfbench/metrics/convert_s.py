"""Seconds a job's thread spent converting the drained rows on the host
(probes/convert.py: `plane_run_pairs`, `unfuse_words`), outside every
stage of the program, per job of the traced window."""

PROBES = ["convert"]


def read(record):
    seconds, jobs = record.get("convert_s"), record.get("jobs")
    if seconds is None or not jobs:
        return None
    return seconds / len(jobs)
