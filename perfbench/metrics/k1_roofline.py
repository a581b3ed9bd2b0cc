"""K1's share of its roofline: the least time of every K1 launch's bytes
and operations (roofline/k1.py) over the device time of the kernels
launched inside `fused_extract_count`.  Bytes bound it."""

from perfbench.readers import roofline_share
from perfbench.roofline import k1

PROBES = ["k1"]


def read(record):
    work = [(k1.n_bytes(B, L, P_pad, W, packed), k1.n_ops(B, P_pad))
            for B, L, P_pad, W, packed in record.get("k1_launches", [])]
    return roofline_share(record, "bench::K1", work)
