"""In-segment all-pairs collapse (plain torch).

Counterpart of the TPU kernel helper kmer_tpu/ops/pallas/fused_count.py
`_dedup_runlen`.  Positions are cut into seg-sized segments; within a
segment each key's count (itself plus the equal keys at later
positions) goes on its FIRST occurrence and later duplicates get 0, as
do sentinel lanes.  Equal keys in different segments stay separate: the
host aggregation merges them (partial-aggregation contract).
"""

from __future__ import annotations

import torch

from ..encode import SENTINEL_KEY


def dedup_runlen(keys: torch.Tensor, seg: int) -> torch.Tensor:
    """(P_pad, B) int64 keys -> (P_pad, B) int8 counts, segments of
    `seg` positions along axis 0 (seg a power of two dividing P_pad)."""
    n, B = keys.shape
    assert n % seg == 0 and seg & (seg - 1) == 0, (n, seg)
    ks = keys.reshape(n // seg, seg, B)
    total = torch.ones(ks.shape, dtype=torch.int32, device=keys.device)
    dupc = torch.zeros(ks.shape, dtype=torch.int32, device=keys.device)
    for d in range(1, seg):
        eq = (ks[:, :seg - d] == ks[:, d:]).to(torch.int32)
        total[:, :seg - d] += eq            # equal key d positions later
        dupc[:, d:] += eq                   # equal key d positions earlier
    first = (dupc == 0) & (ks != SENTINEL_KEY)
    return torch.where(first, total, 0).to(torch.int8).reshape(n, B)
