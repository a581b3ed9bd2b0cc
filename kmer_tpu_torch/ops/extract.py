"""Plain torch k-mer extraction: the reference semantics that the
Hopper kernel (ops/kernels/fused_extract) is held against.

A batch is a (B, L) uint8 code matrix plus per-row lengths and start
limits.  The key of window p of row b is built from k shifted slices of
the code matrix, one int64 per lane (ops/encode key layout).  Lane p of
row b is valid when

    p <= lengths[b] - k,  p < limits[b],  and (mask_ambiguous) no code
    >= 4 inside the window;

invalid lanes carry SENTINEL_KEY.
"""

from __future__ import annotations

import torch

from .encode import SENTINEL_KEY, check_k


def valid_mask(B: int, P: int, lengths: torch.Tensor, span: int,
               limits: torch.Tensor | None, device) -> torch.Tensor:
    """(B, P) bool: window start p lies inside its row and its limit."""
    pos = torch.arange(P, device=device, dtype=torch.int32)[None, :]
    valid = pos <= (lengths.to(torch.int32)[:, None] - span)
    if limits is not None:
        valid = valid & (pos < limits.to(torch.int32)[:, None])
    return valid


def kmer_lanes(codes: torch.Tensor, lengths: torch.Tensor, k: int, *,
               limits: torch.Tensor | None = None, sentinel: bool = True,
               mask_ambiguous: bool = False):
    """All k-mer keys of every read in a batch.

    Returns (keys, valid): keys (B, P) int64 with P = L - k + 1 (invalid
    lanes = SENTINEL_KEY unless sentinel=False), valid (B, P) bool.
    """
    check_k(k)
    B, L = codes.shape
    assert L >= k, f"batch width {L} < k={k}"
    P = L - k + 1
    c = codes.to(torch.int64)
    keys = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
    amb = (torch.zeros((B, P), dtype=torch.bool, device=codes.device)
           if mask_ambiguous else None)
    for j in range(k):
        sl = c[:, j:j + P]
        if mask_ambiguous:
            amb |= sl >= 4
        keys = (keys << 2) | (sl & 3)
    valid = valid_mask(B, P, lengths, k, limits, codes.device)
    if mask_ambiguous:
        valid &= ~amb
    if sentinel:
        keys = torch.where(valid, keys, SENTINEL_KEY)
    return keys, valid
