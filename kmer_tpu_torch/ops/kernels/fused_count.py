"""In-segment all-pairs collapse (plain torch).

Counterpart of the TPU kernel helper kmer_tpu/ops/pallas/fused_count.py
`_dedup_runlen`.  Positions are cut into seg-sized segments; within a
segment each key's count (itself plus the equal keys at later
positions) goes on its FIRST occurrence and later duplicates get 0, as
do sentinel lanes.  Equal keys in different segments stay separate: the
host aggregation merges them (partial-aggregation contract).  A gapped
key is a (hi, lo) pair: two lanes are equal when both words are.
"""

from __future__ import annotations

import torch

from ..encode import SENTINEL_KEY


def dedup_runlen(keys: torch.Tensor, seg: int,
                 lo: torch.Tensor | None = None) -> torch.Tensor:
    """(P_pad, B) int64 keys -> (P_pad, B) int8 counts, segments of
    `seg` positions along axis 0 (seg a power of two dividing P_pad).
    With `lo` the keys are the pairs (keys, lo); sentinels are tested on
    `keys`."""
    n, B = keys.shape
    assert n % seg == 0 and seg & (seg - 1) == 0, (n, seg)
    ks = keys.reshape(n // seg, seg, B)
    ls = lo.reshape(n // seg, seg, B) if lo is not None else None
    total = torch.ones(ks.shape, dtype=torch.int32, device=keys.device)
    dupc = torch.zeros(ks.shape, dtype=torch.int32, device=keys.device)
    for d in range(1, seg):
        eq = ks[:, :seg - d] == ks[:, d:]
        if ls is not None:
            eq &= ls[:, :seg - d] == ls[:, d:]
        eq = eq.to(torch.int32)
        total[:, :seg - d] += eq            # equal key d positions later
        dupc[:, d:] += eq                   # equal key d positions earlier
    first = (dupc == 0) & (ks != SENTINEL_KEY)
    return torch.where(first, total, 0).to(torch.int8).reshape(n, B)
