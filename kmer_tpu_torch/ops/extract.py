"""Plain torch k-mer extraction: the reference semantics that the
Hopper kernels (ops/kernels/fused_extract, ops/kernels/fused_gapped) are
held against.

A batch is a (B, L) uint8 code matrix plus per-row lengths and start
limits.  The key of window p of row b is built from k shifted slices of
the code matrix, one int64 per lane (ops/encode key layout).  Lane p of
row b is valid when

    p <= lengths[b] - k,  p < limits[b],  and (mask_ambiguous) no code
    >= 4 inside the window;

invalid lanes carry SENTINEL_KEY.  gapped_lanes gives the gapped L+R
chunk keys as (hi, lo) int64 pairs (ops/encode).
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


def gapped_lane_count(L: int, c_min: int, c_max: int) -> int:
    """Lanes per row of the c-major gapped stream: sum over chunk sizes
    c in [c_min, c_max] of the exact offset count max(L - c + 1, 0)."""
    return sum(max(L - c + 1, 0) for c in range(c_min, c_max + 1))


def gapped_lanes(codes: torch.Tensor, lengths: torch.Tensor, l_len: int,
                 r_len: int, c_min: int, c_max: int, *,
                 limits: torch.Tensor | None = None,
                 mask_ambiguous: bool = False):
    """All gapped L+R chunk keys of a batch (reference semantics: for
    every chunk size c and offset o, the l_len bases at o and the r_len
    bases ending at o + c).

    Lanes are c-major with the exact width L - c + 1 per chunk size
    (gapped_lane_count in all).  Lane (c, o) is valid when o + c <=
    lengths[b], o < limits[b] and (mask_ambiguous) neither window holds
    an ambiguous base.  Returns (hi, lo, valid), each (B, T): hi the
    l-mer value, lo the r-mer value, SENTINEL_KEY in both on invalid
    lanes.
    """
    if not (l_len >= 1 and r_len >= 1 and c_min >= l_len + r_len):
        raise ValueError("gapped keys need l_len, r_len >= 1 and c_min >= "
                         "l_len + r_len (non-overlapping windows)")
    B, L = codes.shape
    T = gapped_lane_count(L, c_min, c_max)
    dev = codes.device
    if T == 0:
        empty = torch.empty((B, 0), dtype=torch.int64, device=dev)
        return empty, empty.clone(), torch.empty((B, 0), dtype=torch.bool,
                                                 device=dev)
    lk, lval = kmer_lanes(codes, lengths, l_len, sentinel=False,
                          mask_ambiguous=mask_ambiguous)
    if r_len == l_len:
        rk, rval = lk, lval
    else:
        rk, rval = kmer_lanes(codes, lengths, r_len, sentinel=False,
                              mask_ambiguous=mask_ambiguous)
    lens = lengths.to(torch.int32)[:, None]
    lims = limits.to(torch.int32)[:, None] if limits is not None else None
    his, los, vals = [], [], []
    for c in range(c_min, min(c_max, L) + 1):
        O_c = L - c + 1
        o = torch.arange(O_c, dtype=torch.int32, device=dev)[None, :]
        v = (o + c) <= lens
        if lims is not None:
            v = v & (o < lims)
        q = c - r_len                        # the R window starts at o + q
        if mask_ambiguous:
            v = v & lval[:, :O_c] & rval[:, q:q + O_c]
        his.append(lk[:, :O_c])
        los.append(rk[:, q:q + O_c])
        vals.append(v)
    valid = torch.cat(vals, dim=1)
    hi = torch.where(valid, torch.cat(his, dim=1), SENTINEL_KEY)
    lo = torch.where(valid, torch.cat(los, dim=1), SENTINEL_KEY)
    return hi, lo, valid
