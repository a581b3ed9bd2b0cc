"""One job: `kmer_tpu_torch.count_fasta(path, KmerConfig(**fields))` on
the card, an exact `KmerTable`; judged row for row against the plain
reference (perfbench/reference.py)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

# the program's loaders of what a job runs, built at once in set-up:
# ingest's packer, K1, K6 and the host's sort-reduce
LIBRARIES = ("kmer_tpu_torch.io.fasta:load_native",
             "kmer_tpu_torch.ops.kernels.fused_extract:load",
             "kmer_tpu_torch.ops.kernels.sort:load",
             "kmer_tpu_torch.pipeline.nativeagg:load")


def make(fields: dict):
    from kmer_tpu_torch import KmerConfig
    return KmerConfig(**fields)


def run(path: str, cfg, device: str):
    from kmer_tpu_torch import count_fasta
    return count_fasta(path, cfg, device=device)


def work(fields: dict, lengths: np.ndarray) -> int:
    """The k-mers a job counts: every window of k bases in every read."""
    return int(np.maximum(lengths - fields["k"] + 1, 0).sum())


def _rows(table, k: int, device):
    cols = [torch.from_numpy(c).to(device)
            for c in reference.words_to_cols(table.keys, k)]
    return cols, torch.from_numpy(np.asarray(table.counts, np.int64)).to(
        device)


def check(tables: list, path: str, fields: dict, lengths: np.ndarray,
          device: str) -> list[tuple[str, int, int]]:
    """(name, reading, limit) of each number compared, over every job's
    table: the most rows any table has that the reference does not, or
    lacks (limit 0: the counts are exact), and the largest gap between a
    table's total and the k-mers of the corpus (limit 0)."""
    k, canonical = fields["k"], fields.get("canonical", False)
    want_cols, want_counts = reference.count_kmers(path, k, canonical,
                                                   device)
    expected = work(fields, lengths)
    worst_rows = worst_total = 0
    first = None
    for table in tables:
        same = (first is not None
                and np.array_equal(table.keys, first[0].keys)
                and np.array_equal(table.counts, first[0].counts))
        if same:
            rows = first[1]
        else:
            rows = reference.mismatched_rows(*_rows(table, k, device),
                                             want_cols, want_counts)
            if first is None:
                first = (table, rows)
        worst_rows = max(worst_rows, rows)
        worst_total = max(worst_total, abs(int(table.counts.sum())
                                           - expected))
    return [("mismatched_rows", worst_rows, 0),
            ("kmers_total_gap", worst_total, 0)]
