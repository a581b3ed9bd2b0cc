"""The device merge's share of its roofline: the live rows each merge
must read and write and the lanes it takes (roofline/merge.py), over the
device time of every kernel launched inside `merge_batch` (K6, the scans,
compares and scatters).  Bytes bound it."""

from perfbench.readers import roofline_share
from perfbench.roofline import merge

PROBES = ["merges"]


def read(record):
    work = [(merge.n_bytes(m["W"], m["before"], m["after"], m["N"],
                           m["lane_bytes"]), merge.n_ops(m["W"], m["N"]))
            for m in record.get("merges", [])]
    return roofline_share(record, "bench::merge_batch", work)
