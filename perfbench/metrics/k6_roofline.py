"""K6's share of its roofline in the device merges: each merge's sort of
its state and lanes (C + N rows of W key words and a count) as
roofline/k6.py counts it, over the device time of the kernels launched
inside `sort_words` there.  Bytes bound it."""

from perfbench.readers import roofline_share
from perfbench.roofline import k6

PROBES = ["merges", "k6"]


def read(record):
    work = []
    for m in record.get("merges", []):
        n = m["C"] + m["N"]
        work.append((k6.n_bytes(n, m["W"] + 1), k6.n_ops(n, m["W"])))
    return roofline_share(record, "bench::K6", work)
