"""Configuration for the counting engine.

Same field names and defaults as kmer_tpu.config.KmerConfig, so a config
written for one package reads the same in the other.  Every key width
kmer_tpu counts, every path here counts; a seed mask selecting more than
63 bases is refused, as kmer_tpu refuses it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .ops.encode import gapped_bases, word_bases, words_per_key
from .ops.extract import check_window, parse_seed_mask
from .utils.linkspeed import dense_auto_ok


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
    # sort mode, contiguous keys: > 0 is the group size m of the unfused
    # count step (ops/count.grouped_count; the fused step ignores it);
    # 0 selects one exact flat sort instead (K7 + K6, even under
    # KMER_TPU_STEP=auto) and turns the device merge off, as in kmer_tpu;
    # compact=True keeps the fused step under auto whatever it is
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
    # spaced seed: a 0/1 match mask ("1101011"); the key of each window
    # of span len(mask) is the bases at the '1' offsets (k is ignored).
    # Sort mode, not compact, not gapped; canonical needs a palindromic
    # mask
    seed_mask: str | None = None
    stats: bool = False                     # per-batch JSONL stats to stderr

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.device_merge not in ("auto", "on", "off"):
            raise ValueError(
                f"device_merge={self.device_merge!r} not in auto/on/off")
        if self.sort_group_keys < 0:
            raise ValueError("sort_group_keys must be >= 0, got "
                             f"{self.sort_group_keys}")
        if self.mode not in ("auto", "dense", "sort"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "dense" and self.k > 12:
            raise ValueError("dense mode requires k <= 12")
        if self.gapped and self.mode == "dense":
            raise ValueError("gapped mode requires sort mode")
        if self.gapped and (self.l_len < 1 or self.r_len < 1):
            raise ValueError("gapped mode needs l_len, r_len >= 1")
        if self.gapped and self.c_min < self.l_len + self.r_len:
            raise ValueError("gapped mode needs c_min >= l_len + r_len "
                             "(non-overlapping L/R windows)")
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
        if self.compact and words_per_key(self.n_bases) > 7:
            raise ValueError("compact mode caps at 7 key words "
                             f"(<= 111 bases; got {self.n_bases})")
        if self.compact and self.mode == "dense":
            raise ValueError("compact applies to sort mode")
        if self.seed_mask is not None:
            self._check_seed_mask()

    def _check_seed_mask(self) -> None:
        """kmer_tpu's spaced-seed checks (kmer_tpu/config.py:127-146)."""
        pos = parse_seed_mask(self.seed_mask)        # raises on a bad mask
        check_window(len(pos), pos, self.canonical)
        if self.gapped:
            raise ValueError("seed_mask and gapped are exclusive")
        if self.effective_mode != "sort":
            raise ValueError("seed_mask requires sort mode")
        if self.compact:
            raise ValueError("seed_mask does not support compact")

    @property
    def n_bases(self) -> int:
        """Bases per key (the key width): the seed mask's popcount,
        l_len + r_len gapped, else k."""
        if self.seed_mask is not None:
            return self.seed_mask.count("1")
        return (self.l_len + self.r_len) if self.gapped else self.k

    @property
    def plane_bases(self) -> tuple[int, ...]:
        """The bases of each int64 key plane on the device (ops/encode):
        K3's split or the general layout of a gapped key, else the
        general layout of n_bases."""
        if self.gapped:
            return gapped_bases(self.l_len, self.r_len)
        return word_bases(self.n_bases)

    @property
    def seed_positions(self) -> tuple[int, ...] | None:
        """The seed mask's match offsets, or None for contiguous keys."""
        if self.seed_mask is None:
            return None
        return parse_seed_mask(self.seed_mask)

    @property
    def window_span(self) -> int:
        """Longest window the extractor needs in one batch row."""
        if self.seed_mask is not None:
            return len(self.seed_mask)
        return self.c_max if self.gapped else self.k

    @property
    def overlap(self) -> int:
        """Host-side segment overlap so split reads lose no windows."""
        return self.window_span - 1

    @property
    def effective_mode(self) -> str:
        """The mode a run takes.  auto is dense only for contiguous,
        uncompacted k <= 8 behind a device-to-host link slower than
        utils/linkspeed.DENSE_BREAKEVEN_GBPS (probed on the default
        device at the first call, or KMER_TPU_D2H_GBPS), as kmer_tpu's;
        else sort.  The two modes give the same table."""
        if self.mode != "auto":
            return self.mode
        if (self.compact or self.gapped or self.seed_mask is not None
                or self.k > 8):
            return "sort"
        return "dense" if dense_auto_ok() else "sort"

    def replace(self, **kw) -> "KmerConfig":
        return dataclasses.replace(self, **kw)
