"""Streaming distinct-k-mer estimation driver (ops/sketch.py), the
`card` command.

One pass over the corpus: each batch is shipped once and sketched at
every k (kernel K1 up to 63 bases, K7 beyond, then K5; a list such as
21 and 101 mixes them).  The (2**(b + 5),) int64 class histogram of each k lives on the
device across all batches and crosses to the host once at the end, so
peak host memory and the device-to-host copy are O(2**b) whatever the
corpus size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import KmerConfig
from ..ops.sketch import estimate_from_histogram, hll_step
from ..utils.stats import StatsLogger
from .count import dispatch_batches, iter_chunks, resolve_device


def estimate_distinct_files(paths, cfg: KmerConfig | None = None, *,
                            b: int = 10, device="cuda", **cfg_kw):
    """Estimated number of DISTINCT k-mers (and the exact total) across
    FASTA/FASTQ files: (estimate: float, total_kmers: int).  b is the
    HLL precision: 2**b buckets, relative error ~ 1.04/sqrt(2**b)."""
    cfg = cfg or KmerConfig(**cfg_kw)
    [(est, total)] = estimate_distinct_multi_k(paths, [cfg.k], cfg, b=b,
                                               device=device)
    return est, total


def sketch_histograms(paths, ks, cfg: KmerConfig, *, b: int = 10,
                      device="cuda"):
    """The class histogram of every k in one ingest pass:
    ({k: (2**(b + 5),) int64 numpy histogram}, {k: windows extracted})
    with ks deduplicated.  cfg.max_read_len must take max(ks).  With
    cfg.seed_mask the one key width is the mask's popcount (ks is
    ignored) and the window spans the mask, as kmer_tpu's estimator."""
    if cfg.gapped:
        raise ValueError("estimation applies to contiguous k-mers")
    if not 1 <= b <= 11:
        raise ValueError(f"buckets_log2 must be in [1, 11] (class width "
                         f"b+5 <= 16 bits), got {b}")
    positions = cfg.seed_positions
    if positions is not None:
        ks = [len(positions)]
    ks = list(dict.fromkeys(ks))      # a repeated k would double-count
    if not ks or any(kk < 1 for kk in ks):
        raise ValueError(f"bad k list {ks}")
    span = cfg.window_span if positions is not None else max(ks)
    if cfg.max_read_len < span:
        raise ValueError(f"max_read_len={cfg.max_read_len} < window "
                         f"span {span}")
    dev = resolve_device(device)
    if isinstance(paths, str):
        paths = [paths]
    hists = {kk: torch.zeros(1 << (b + 5), dtype=torch.int64, device=dev)
             for kk in ks}
    totals = {kk: 0 for kk in ks}

    def step(codes_d, lengths_d, limits_d, pw):
        for kk in ks:
            hll_step(codes_d, lengths_d, limits_d, hists[kk], k=kk,
                     canonical=cfg.canonical, b=b,
                     mask_ambiguous=cfg.skip_invalid, packed_width=pw,
                     positions=positions)

    log = StatsLogger(enabled=cfg.stats)
    # batches overlap by the LARGEST span - 1, so every k's windows are
    # each extracted once with one batching
    for codes, offsets in iter_chunks(paths, cfg):
        for batch, _ in dispatch_batches(codes, offsets, cfg, dev, step, log,
                                         span=span):
            for kk in ks:
                # windows of a row: start below its limit, end in its read
                w = span if positions is not None else kk
                ends = np.minimum(batch.lengths, batch.start_limits + w - 1)
                totals[kk] += int(np.maximum(ends - w + 1, 0).sum())
    return {kk: h.cpu().numpy() for kk, h in hists.items()}, totals


def estimate_distinct_multi_k(paths, ks, cfg: KmerConfig | None = None,
                              *, b: int = 10, device="cuda", **cfg_kw):
    """ntCard-style multi-k estimation in one ingest pass: every batch
    crosses once and is sketched at every k.  Returns [(estimate,
    total_kmers)] aligned with the deduplicated `ks` (one entry, the
    spaced keys', under cfg.seed_mask).

    The histograms are int64, so no cell saturates and the strict-mode
    check always holds: without skip_invalid every extractable window is
    hashed, and the histogram's sum must equal the host's window count.
    With skip_invalid the total reported is the sketched count."""
    cfg = cfg or KmerConfig(**cfg_kw)
    hists, totals = sketch_histograms(paths, ks, cfg, b=b, device=device)
    out = []
    for kk, h in hists.items():
        hashed = int(h.sum())
        if not cfg.skip_invalid and hashed != totals[kk]:
            raise RuntimeError(
                f"HLL histogram lost windows at k={kk}: sketched {hashed} "
                f"!= extracted {totals[kk]}")
        total = totals[kk] if not cfg.skip_invalid else hashed
        out.append((estimate_from_histogram(h, b), total))
    return out
