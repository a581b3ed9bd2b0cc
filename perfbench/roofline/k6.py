"""K6, the radix sort (`csrc/sort.cu`), one call over n rows of `planes`
int64 planes (the key words and the payload): each row read once and
written once, and n ceil(log2 n) comparisons of the key words."""

from __future__ import annotations

import math


def n_bytes(n: int, planes: int) -> int:
    return 2 * n * planes * 8


def n_ops(n: int, num_keys: int) -> int:
    return n * max(1, math.ceil(math.log2(max(n, 2)))) * num_keys
