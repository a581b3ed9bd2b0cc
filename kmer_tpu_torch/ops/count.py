"""Device-side counting primitives shared by the counting pipelines.

Counterpart of kmer_tpu/ops/count.py on int64 word planes: W planes of
equal length (one key of up to 31 bases, a (hi, lo) pair -- gapped, or a
key of 32 to 63 bases -- or the W words of any wider key, ops/encode),
SENTINEL_KEY in every word of a dead lane.  kmer_tpu repacks its uint32
key words into a sort layout first (repack_words); an int64 key is
already in sort order, so nothing here repacks.

- sort_words: the flat multiset sort (kernel K6 on a GPU).
- sort_count: one exact flat sort plus run lengths (sort_group_keys=0).
- grouped_count: the unfused count step's core: the flat lanes padded
  with sentinel lanes to a multiple of m, cut into groups of m, each
  sorted and run-length counted (kernels K2a, K2b or K2c on a GPU, by
  KMER_TPU_GROUPED), or deduplicated without a sort.  Partial
  aggregation: equal keys may recur across groups; the host sums them.
- grouped_count_compact: grouped_count, then the live lanes packed into
  host-ready records (kernel K4).

Counts are int32 and sit at the first lane of each run; every other lane
and every dead lane has 0.
"""

from __future__ import annotations

import os

import torch

from .encode import SENTINEL_KEY
from .kernels import compact as compact_kernel
from .kernels import grouped_count as grouped_kernel
from .kernels import sort as sort_kernel

GROUPED_BACKENDS = ("auto", "hybrid", "xla", "pallas", "pallas_t", "dedup")


def sort_words(words, num_keys=None, bits=None) -> list[torch.Tensor]:
    """Stable multiset sort of W int64 word planes of any shape
    (flattened) by their first num_keys words (default all; word 0 most
    significant), duplicates kept; the other words are payload.  bits:
    each key word's value bits (ops/kernels/sort; default 64, any int64).
    CPU tensors take the plain torch version and are left as they are;
    CUDA tensors are sorted in place by kernel K6 (ops/kernels/sort), so a
    caller passes tensors it no longer needs."""
    return sort_kernel.sort_words([w.reshape(-1) for w in words], num_keys,
                                  bits)


def run_lengths(sorted_words) -> torch.Tensor:
    """Run lengths of a sorted flat key stream: counts (N,) int32, the
    run's length at its first lane, 0 elsewhere and on the sentinel run.
    A run's length is the distance to the next run start, found with one
    reverse cummin (kmer_tpu's scan; plain torch on every device)."""
    n = sorted_words[0].numel()
    dev = sorted_words[0].device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    start = torch.ones(n, dtype=torch.bool, device=dev)
    for w in sorted_words:
        start[1:] &= w[1:] == w[:-1]
    start = ~start
    start[:1] = True
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    suffix = torch.cummin(torch.where(start, idx, n).flip(0), 0).values.flip(0)
    next_start = torch.cat([suffix[1:], torch.full((1,), n, device=dev)])
    live = start & (sorted_words[0] != SENTINEL_KEY)
    return torch.where(live, next_start - idx, 0).to(torch.int32)


def sort_count(words, bits=None):
    """One exact flat sort of the lanes (K6 on a GPU; bits: the key
    words' value bits) and their run lengths: (sorted flat words, counts
    (N,) int32)."""
    s = sort_words(words, bits=bits)
    return s, run_lengths(s)


def sort_words_grouped(words, groups: int) -> list[torch.Tensor]:
    """The flattened words cut into `groups` equal slices, each sorted
    lexicographically: (G, m) planes (stable torch.sort along dim 1)."""
    flat = [w.reshape(-1) for w in words]
    n = flat[0].numel()
    if n % groups:
        raise ValueError(f"{n} lanes do not cut into {groups} groups")
    return grouped_kernel.sort_groups([f.view(groups, n // groups)
                                       for f in flat])


def run_lengths_grouped(sorted_2d) -> torch.Tensor:
    """Run lengths of (G, m) group-sorted planes, runs confined to their
    group: flat (G*m,) int32 counts (K2a on a GPU)."""
    return grouped_kernel.run_lengths_grouped(sorted_2d).reshape(-1)


def _dedup_counts(shaped, seg: int) -> torch.Tensor:
    """All-pairs in-segment dedup over (G, m) planes, no sort: each key's
    count (itself plus its equal keys later in its seg-lane segment) on
    its first occurrence, 0 on later ones and on dead lanes; the keys
    stay in extraction order.  kmer_tpu computes it in XLA
    (ops/count.py:306-320), outside any kernel; here in tensor ops."""
    G, m = shaped[0].shape
    dev = shaped[0].device
    s_idx = torch.arange(m, device=dev) & (seg - 1)
    total = torch.ones((G, m), dtype=torch.int32, device=dev)
    dupc = torch.zeros((G, m), dtype=torch.int32, device=dev)
    for d in range(1, seg):
        eq = (s_idx < seg - d).expand(G, m)
        for w in shaped:
            eq = eq & (w == torch.roll(w, -d, dims=1))          # x[i + d]
        eqi = eq.to(torch.int32)
        total += eqi
        dupc += torch.roll(eqi, d, dims=1)      # the guard kills the wraps
    live = (shaped[0] != SENTINEL_KEY) & (dupc == 0)
    return torch.where(live, total, 0).reshape(-1)


def _resolve_backend(backend: str, n_words: int, m: int) -> str:
    """kmer_tpu's backend policy (ops/count.py:257-348) in the port's
    terms.  auto: dedup for multi-word keys (m a multiple of 8), else
    hybrid; xla is hybrid (the port has no XLA); pallas (K2b) needs m a
    power of two in [128, max_group_rows(W)] and pallas_t (K2c) a power
    of two <= max_group_rows(W), else both fall to hybrid."""
    if backend not in GROUPED_BACKENDS:
        raise ValueError(f"KMER_TPU_GROUPED={backend!r} not in "
                         f"{'/'.join(GROUPED_BACKENDS)}")
    pow2_fits = m & (m - 1) == 0 and m <= grouped_kernel.max_group_rows(
        n_words)
    if backend == "auto":
        return "dedup" if n_words > 1 and m % 8 == 0 else "hybrid"
    if backend == "xla":
        return "hybrid"
    if backend == "pallas" and not (pow2_fits and m >= 128):
        return "hybrid"
    if backend == "pallas_t" and not pow2_fits:
        return "hybrid"
    return backend


def _sorted_grouped_runs(words, group_keys: int, backend: str):
    """Shared core: pad -> grouped sort or dedup -> run lengths.  Returns
    (flat words, counts) of the padded flat size."""
    flat = [w.reshape(-1) for w in words]
    n = flat[0].numel()
    m = max(min(group_keys, n), 1)
    backend = _resolve_backend(backend, len(flat), m)
    pad = (-n) % m
    if pad:
        flat = [torch.cat([w, torch.full((pad,), SENTINEL_KEY,
                                         dtype=w.dtype, device=w.device)])
                for w in flat]
    G = (n + pad) // m
    if backend == "pallas_t":
        # a group is a strided column of the flat stream (element i of
        # group g at i * G + g): a partition as valid as the rows for
        # partial aggregation, and no transpose is materialised
        s, counts = grouped_kernel.grouped_count_strided(
            [w.view(m, G) for w in flat])
        return [w.reshape(-1) for w in s], counts.reshape(-1)
    shaped = [w.view(G, m) for w in flat]
    if backend == "dedup":
        seg = int(os.environ.get("KMER_TPU_DEDUP_SEG", "8"))
        if seg < 1 or seg & (seg - 1) or m % seg:
            raise ValueError(f"KMER_TPU_DEDUP_SEG={seg} must be a power of "
                             f"two dividing the group size {m}")
        return flat, _dedup_counts(shaped, seg)
    if backend == "pallas":
        s, counts = grouped_kernel.grouped_count(shaped)
        return [w.reshape(-1) for w in s], counts.reshape(-1)
    s = sort_words_grouped(flat, G)                             # hybrid
    return [w.reshape(-1) for w in s], run_lengths_grouped(s)


def grouped_count(words, group_keys: int, backend: str | None = None):
    """The unfused sort-mode count core over W int64 planes (any shape;
    flattened): (flat words (N_pad,), counts (N_pad,) int32), N_pad the
    lanes padded to a multiple of m = min(group_keys, N) (at least 1).

    Backends (KMER_TPU_GROUPED, default auto; kmer_tpu's names):
      hybrid    the grouped torch.sort + run lengths (K2a on a GPU);
      xla       the same as hybrid;
      pallas    per-group sort + run lengths in one kernel (K2b);
      pallas_t  K2b over the strided-column groups (K2c);
      dedup     all-pairs in-segment dedup, no sort (KMER_TPU_DEDUP_SEG,
                default 8; tensor ops, no kernel);
      auto      dedup for multi-word keys, hybrid for one word.
    CPU tensors run each backend's plain version.  One call serves
    kmer_tpu's grouped_count and grouped_count_repacked: int64 keys need
    no repack."""
    backend = backend or os.environ.get("KMER_TPU_GROUPED", "auto")
    return _sorted_grouped_runs(words, group_keys, backend)


def grouped_count_compact(words, group_keys: int, *, bases=None,
                          backend: str | None = None):
    """grouped_count, then the live lanes as host-ready records
    (ops/kernels/compact, kernel K4 on a GPU): (keys, counts int64, total
    (1,) int64); bases: each plane's bases (ops/encode) for two or more
    planes."""
    s, counts = grouped_count(words, group_keys, backend=backend)
    if len(s) == 2:
        return compact_kernel.compact(s, counts, r_len=bases[1],
                                      n_bases=sum(bases))
    return compact_kernel.compact(s, counts)
