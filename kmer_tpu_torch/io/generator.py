"""Seeded FASTA and FASTQ corpus generators (numpy only): the same text
as kmer_tpu.io.generator for the same arguments and seed, since each
draws from the generator in the same order."""

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


def random_reads_fasta(n_reads: int, read_len: int, seed: int = 0,
                       wrap: int | None = None) -> str:
    """n_reads uniform-random reads of read_len bp, each on one line or
    on lines of `wrap` bases."""
    return _to_fasta(random_codes(n_reads, read_len, seed), "read", wrap)


def random_codes(n_reads: int, read_len: int, seed: int = 0) -> np.ndarray:
    """The (n_reads, read_len) uint8 2-bit codes of random_reads_fasta's
    reads, with no text."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)


def random_reads_fastq(n_reads: int, read_len: int, seed: int = 0,
                       qual_range: tuple[int, int] | None = None) -> str:
    """n_reads uniform-random FASTQ reads.  Quality is constant 'I'
    (Phred 40) unless qual_range=(lo, hi) draws per-base Phred scores
    uniformly from [lo, hi) (for --min-qual)."""
    rng = np.random.default_rng(seed)
    ascii_rows = _BASES[rng.integers(0, 4, (n_reads, read_len),
                                     dtype=np.uint8)]
    if qual_range is None:
        quals = np.full((n_reads, read_len), ord("I"), np.uint8)
    else:
        lo, hi = qual_range
        quals = (rng.integers(lo, hi, (n_reads, read_len)) + 33).astype(
            np.uint8)
    buf = _io.StringIO()
    for i in range(n_reads):
        buf.write(f"@read_{i:06d}\n")
        buf.write(ascii_rows[i].tobytes().decode())
        buf.write("\n+\n")
        buf.write(quals[i].tobytes().decode())
        buf.write("\n")
    return buf.getvalue()


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


def _to_fasta(codes: np.ndarray, prefix: str, wrap: int | None = None
              ) -> str:
    ascii_rows = _BASES[codes]
    buf = _io.StringIO()
    for i in range(len(codes)):
        buf.write(f">{prefix}_{i:06d}\n")
        row = ascii_rows[i].tobytes().decode()
        if wrap:
            for j in range(0, len(row), wrap):
                buf.write(row[j:j + wrap])
                buf.write("\n")
        else:
            buf.write(row)
            buf.write("\n")
    return buf.getvalue()
