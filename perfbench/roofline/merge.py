"""One device merge (`ops/devmerge.merge_batch`) as work, whatever
kernels do it: the live rows of the state before it (W int64 key words
and an int64 count, 8 (W + 1) bytes a row) and the N lanes merged (at
the bytes they arrive in) read once, the live rows after it written
once; sorting the N lanes takes N ceil(log2 N) comparisons of W words.
The state's sentinel padding is not work."""

from __future__ import annotations

import math


def n_bytes(W: int, before: int, after: int, N: int, lane_bytes: int) -> int:
    return 8 * (W + 1) * (before + after) + N * lane_bytes


def n_ops(W: int, N: int) -> int:
    return N * max(1, math.ceil(math.log2(max(N, 2)))) * W
