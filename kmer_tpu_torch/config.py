"""Configuration for the counting engine.

Same field names and defaults as kmer_tpu.config.KmerConfig, so a config
written for one package reads the same in the other.  The options this
port does not carry yet raise NotImplementedError naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .ops.encode import MAX_K


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to kmer_tpu_torch yet (ROADMAP Queue 1 "
        f"item {item})")


@dataclass(frozen=True)
class KmerConfig:
    k: int = 21
    canonical: bool = False
    mode: str = "auto"                      # auto | dense | sort
    batch_reads: int = 8192                 # reads (segments) per device batch
    max_read_len: int = 256                 # batch width L; longer reads split
    gapped: bool = False
    l_len: int = 27
    r_len: int = 27
    c_min: int = 80
    c_max: int = 140
    sort_group_keys: int = 256
    partitions: int = 16
    # bounded-memory ingest: parse inputs in record-aligned windows of at
    # most this many bases (io.fasta.iter_parse_chunks); 0 = whole file
    ingest_chunk_bases: int = 1 << 28
    compact: bool = False
    device_merge: str = "auto"              # auto | on | off
    # ship batches 2-bit packed (4x smaller host-to-device copy); off in
    # skip_invalid mode, where the ambiguity code needs a third bit
    packed_transfer: bool = True
    # accept N/IUPAC codes and drop every window containing one
    skip_invalid: bool = False
    # FASTQ: mask bases below this Phred+33 quality to the ambiguous
    # code (requires skip_invalid)
    min_qual: int = 0
    seed_mask: str | None = None
    stats: bool = False                     # per-batch JSONL stats to stderr

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.device_merge not in ("auto", "on", "off"):
            raise ValueError(
                f"device_merge={self.device_merge!r} not in auto/on/off")
        if self.mode not in ("auto", "dense", "sort"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "dense" and self.k > 12:
            raise ValueError("dense mode requires k <= 12")
        if self.max_read_len < self.window_span:
            raise ValueError(f"max_read_len={self.max_read_len} < window "
                             f"span {self.window_span}")
        if not 0 <= self.min_qual <= 93:
            raise ValueError("min_qual must be in [0, 93] (Phred+33 "
                             f"range), got {self.min_qual}")
        if self.min_qual > 0 and not self.skip_invalid:
            raise ValueError("min_qual masks bases to the ambiguous "
                             "code; set skip_invalid=True (CLI: "
                             "--min-qual implies --skip-invalid)")
        if self.gapped:
            raise _not_ported("gapped", "7 (gapped counting and parity)")
        if self.seed_mask is not None:
            raise _not_ported("seed_mask", "8 (spaced seeds)")
        if self.compact:
            raise _not_ported("compact", "10 (on-device compaction)")
        if self.mode == "dense":
            raise _not_ported('mode="dense"', "9 (dense mode and HLL)")
        if self.device_merge == "on":
            raise _not_ported('device_merge="on"',
                              "11 (device-resident table)")
        if self.k > MAX_K:
            raise _not_ported(f"k={self.k} > {MAX_K}",
                              "5 (two-word int64 keys, 32 <= k <= 63)")

    @property
    def n_bases(self) -> int:
        """Bases per key (the key width)."""
        return self.k

    @property
    def window_span(self) -> int:
        """Longest window the extractor needs in one batch row."""
        return self.k

    @property
    def overlap(self) -> int:
        """Host-side segment overlap so split reads lose no windows."""
        return self.window_span - 1

    @property
    def effective_mode(self) -> str:
        """Always "sort": kmer_tpu's dense mode gives the same tables
        (its config.py documents that), and the port has no dense path
        yet, so "auto" needs no link probe."""
        return "sort"

    def replace(self, **kw) -> "KmerConfig":
        return dataclasses.replace(self, **kw)
