"""Order-preserving spill routing for the streaming paths.

Only route_partition is ported so far: the bounded-memory parity dump
(pipeline/parity.parity_dump_stream) spills its sorted lines by it.  The
streaming two-pass counter with checkpoint/resume is ROADMAP Queue 1
item 12.
"""

from __future__ import annotations

import numpy as np

from ..ops.encode import words_per_key


def route_partition(keys: np.ndarray, n_bases: int, n_parts: int,
                    route_bits: int = 16) -> np.ndarray:
    """Order-preserving partition id of each key.

    keys: (M, W) uint32, most significant word first, no sentinels.
    Returns (M,) int64 part = top_bits * n_parts // 2**tb: monotone in
    the key, so sorted keys give non-decreasing partition ids and the
    partitions, concatenated in order, stay sorted.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    W = keys.shape[1]
    if W != words_per_key(n_bases):
        raise ValueError(f"{W} key words for {n_bases} bases")
    tb = min(route_bits, 2 * n_bases)
    avail0 = 2 * n_bases - 32 * (W - 1)      # value bits held in word 0
    if avail0 >= tb:
        h = (keys[:, 0] >> np.uint32(avail0 - tb)) & np.uint32((1 << tb) - 1)
    else:
        need = tb - avail0
        hi = ((keys[:, 0].astype(np.uint64) & np.uint64((1 << avail0) - 1))
              << np.uint64(need))
        lo = keys[:, 1].astype(np.uint64) >> np.uint64(32 - need)
        h = hi | lo
    return (h.astype(np.int64) * n_parts) >> tb
