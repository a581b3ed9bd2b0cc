"""Canonical k-mer selection on int64 keys (plain torch).

canonical(kmer) = min(forward, reverse complement) as 2k-bit integers,
which equals the lexicographic min of the two strings.
"""

from __future__ import annotations

import torch

from .encode import SENTINEL_KEY
from .extract import kmer_lanes

# (shift, mask) butterfly steps reversing the 32 two-bit fields of a
# 64-bit word; every mask is below 2^63, so `(x >> n) & m` also clears
# the copies of the sign bit that int64's arithmetic shift brings in
_BUTTERFLY = ((32, 0x00000000FFFFFFFF), (16, 0x0000FFFF0000FFFF),
              (8, 0x00FF00FF00FF00FF), (4, 0x0F0F0F0F0F0F0F0F),
              (2, 0x3333333333333333))


def revcomp_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2k-bit int64 keys by bit tricks:
    complement = NOT, reversal = field butterfly, then the 2k key bits
    (now at the top of the word) shift down."""
    x = ~keys
    for n, m in _BUTTERFLY:
        x = ((x >> n) & m) | ((x & m) << n)
    return (x >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def canonical_kmer_lanes(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                         *, limits: torch.Tensor | None = None,
                         mask_ambiguous: bool = False):
    """min(forward, revcomp) key per lane; SENTINEL_KEY on invalid
    lanes.  Same contract as extract.kmer_lanes."""
    fwd, valid = kmer_lanes(codes, lengths, k, limits=limits, sentinel=False,
                            mask_ambiguous=mask_ambiguous)
    mn = torch.minimum(fwd, revcomp_keys(fwd, k))
    return torch.where(valid, mn, SENTINEL_KEY), valid
