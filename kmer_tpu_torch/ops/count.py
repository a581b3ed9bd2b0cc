"""Device-side counting primitives shared by the counting pipelines.

Counterpart of kmer_tpu/ops/count.py.  Only its sort front door is
ported so far; kmer_tpu's grouped-count route (grouped_count,
_sorted_grouped_runs, which reach the TPU kernels K2a-c) has no user in
the port yet, because the fused count steps (kernels K1, K3) collapse
in-segment duplicates themselves.
"""

from __future__ import annotations

import torch

from .kernels import sort as sort_kernel


def sort_words(words) -> list[torch.Tensor]:
    """Lexicographic multiset sort of W in 1..4 int64 word planes of any
    shape (flattened; word 0 most significant), duplicates kept.  CPU
    tensors take the plain torch version and are left as they are; CUDA
    tensors are sorted in place by kernel K6 (ops/kernels/sort), so a
    caller passes tensors it no longer needs."""
    return sort_kernel.sort_words([w.reshape(-1) for w in words])
