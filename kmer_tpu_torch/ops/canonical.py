"""Canonical k-mer selection (plain torch).

canonical(kmer) = min(forward, reverse complement) as 2k-bit integers,
which equals the lexicographic min of the two strings.  The reverse
complement is built from the complemented codes in reverse order, in the
key's own layout (one int64, or words64(k) words of 31 bases each, the
last holding the rest, so the min of two keys is lexicographic over
their words; ops/extract.window_keys).
"""

from __future__ import annotations

import torch

from .encode import check_n_bases
from .extract import window_keys


def canonical_kmer_lanes(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                         *, limits: torch.Tensor | None = None,
                         mask_ambiguous: bool = False):
    """min(forward, revcomp) key per lane; SENTINEL_KEY on invalid
    lanes.  Same contract as extract.kmer_lanes."""
    check_n_bases(k)
    return window_keys(codes, lengths, range(k), limits=limits,
                       mask_ambiguous=mask_ambiguous, canonical=True)
