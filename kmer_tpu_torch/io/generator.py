"""Seeded FASTA corpus generators (numpy only): the same text as
kmer_tpu.io.generator for the same arguments and seed."""

from __future__ import annotations

import io as _io

import numpy as np

from ..ops.encode import BASE_ORDER

_BASES = np.frombuffer(BASE_ORDER.encode(), dtype=np.uint8)


def reference_style_fasta(n_records: int = 200, lines_per_record: int = 5,
                          line_len: int = 80, pool_size: int = 10,
                          seed: int = 0) -> str:
    """Records in the shape of the reference generator's output: each
    record `lines_per_record` lines drawn from a pool of `pool_size`
    shared random lines, so gapped chunks recur (multiplicity > 1)."""
    rng = np.random.default_rng(seed)
    pool = ["".join(BASE_ORDER[c] for c in rng.integers(0, 4, line_len))
            for _ in range(pool_size)]
    buf = _io.StringIO()
    for i in range(1, n_records + 1):
        buf.write(f">dummy_sequence_{i:03d} {i}th record\n")
        for _ in range(lines_per_record):
            buf.write(pool[int(rng.integers(0, pool_size))])
            buf.write("\n")
    return buf.getvalue()


def random_reads_fasta(n_reads: int, read_len: int, seed: int = 0) -> str:
    """n_reads uniform-random reads of read_len bp."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)
    return _to_fasta(codes, "read")


def genome_reads_fasta(n_reads: int, read_len: int, genome_len: int = 100_000,
                       seed: int = 0, error_rate: float = 0.0,
                       revcomp: bool = True) -> str:
    """Reads sampled from ONE random genome: at coverage
    n_reads*read_len/genome_len most k-mers recur ~coverage times, the
    duplicate structure real sequencing data has.  Optional per-base
    substitution errors and reverse-complement strands."""
    if read_len > genome_len:
        raise ValueError(f"read_len={read_len} > genome_len={genome_len}")
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
    if error_rate > 0:
        err = rng.random(codes.shape) < error_rate
        codes = np.where(err, (codes + rng.integers(1, 4, codes.shape)) % 4,
                         codes).astype(np.uint8)
    if revcomp:
        flip = rng.random(n_reads) < 0.5
        codes = np.where(flip[:, None], (3 - codes)[:, ::-1],
                         codes).astype(np.uint8)
    return _to_fasta(codes, "gread")


def _to_fasta(codes: np.ndarray, prefix: str) -> str:
    ascii_rows = _BASES[codes]
    buf = _io.StringIO()
    for i in range(len(codes)):
        buf.write(f">{prefix}_{i:06d}\n")
        buf.write(ascii_rows[i].tobytes().decode())
        buf.write("\n")
    return buf.getvalue()
