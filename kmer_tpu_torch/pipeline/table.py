"""Host-side k-mer count table: sorted unique keys + counts.

KmerTable stores the same (M, W) uint32 most-significant-first key words
as kmer_tpu.pipeline.table.KmerTable (ops/encode layout), so two tables
compare with ==, write the same TSV and save the same .npz in both
packages.  Aggregation works on keys FUSED into one uint64 column: for
k <= 31 (W <= 2) the fused column (w0 << 32 | w1) is exactly the int64
key the device step emits, so device output needs no conversion before
the sort.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..ops.encode import check_k, decode_key_words, words_per_key


def fuse_words(keys: np.ndarray, k: int) -> np.ndarray:
    """(M, W) uint32 key words -> (M,) uint64 key values (W <= 2)."""
    W = words_per_key(k)
    keys = np.ascontiguousarray(keys, dtype=np.uint32).reshape(-1, W)
    if W == 1:
        return keys[:, 0].astype(np.uint64)
    if sys.byteorder == "little":
        # the uint64 view reads (w0 | w1 << 32); a 32-bit rotate swaps it
        v = keys.view(np.uint64).reshape(-1)
        return (v >> np.uint64(32)) | (v << np.uint64(32))
    return (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1]


def unfuse_words(fused: np.ndarray, k: int) -> np.ndarray:
    """Inverse of fuse_words: (M,) uint64 -> (M, W) uint32."""
    W = words_per_key(k)
    if W == 1:
        return fused.astype(np.uint32).reshape(-1, 1)
    if sys.byteorder == "little":
        rot = (fused >> np.uint64(32)) | (fused << np.uint64(32))
        return np.ascontiguousarray(rot.view(np.uint32).reshape(-1, 2))
    kb = np.empty((len(fused), 2), np.uint32)
    kb[:, 0] = fused >> np.uint64(32)
    kb[:, 1] = fused.astype(np.uint32)
    return kb


def reduce_fused(fused: np.ndarray, counts: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Unsorted (uint64 key, int64 count) pairs -> (sorted unique keys,
    summed counts).  Large inputs go to the native bucket-parallel
    sort-reduce (pipeline/nativeagg); small ones to one numpy argsort."""
    counts = np.asarray(counts, dtype=np.int64)
    if len(counts) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    from .nativeagg import aggregate_fused
    nat = aggregate_fused([fused], counts)
    if nat is not None:
        cols_ms, merged = nat
        return cols_ms[0], merged
    order = np.argsort(fused)              # unstable is fine: equal keys
    fs = fused[order]                      # are identical
    new_run = np.empty(len(fs), bool)
    new_run[0] = True
    np.not_equal(fs[1:], fs[:-1], out=new_run[1:])
    if int(np.count_nonzero(new_run)) == len(fs):
        return fs, counts[order]           # all distinct: nothing to sum
    starts = np.flatnonzero(new_run)
    return fs[starts], np.add.reduceat(counts[order], starts)


@dataclass
class KmerTable:
    k: int                 # bases per key
    keys: np.ndarray       # (M, W) uint32, lexicographically sorted, unique
    counts: np.ndarray     # (M,) int64

    @property
    def num_distinct(self) -> int:
        return int(self.keys.shape[0])

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def kmers(self) -> list[str]:
        return decode_key_words(self.keys, self.k)

    def items(self):
        return zip(self.kmers(), self.counts.tolist())

    def to_dict(self) -> dict[str, int]:
        return dict(self.items())

    def write_tsv(self, stream, chunk: int = 1 << 20) -> None:
        """"KMER\\tCOUNT\\n" rows in key order, on a text or binary
        stream; large chunks render natively (pipeline/nativeagg)."""
        from ..ops.encode import decode_key_words_to_bytes
        from .nativeagg import format_tsv_rows
        binary = not hasattr(stream, "encoding")
        for lo in range(0, self.num_distinct, chunk):
            hi = min(lo + chunk, self.num_distinct)
            lines = format_tsv_rows(self.keys[lo:hi], self.counts[lo:hi],
                                    self.k)
            if lines is None:
                kmers = decode_key_words_to_bytes(self.keys[lo:hi], self.k)
                counts = np.char.mod(b"%d", self.counts[lo:hi])
                lines = (np.char.add(np.char.add(kmers, b"\t"),
                                     np.char.add(counts, b"\n"))
                         .tobytes())
                # |S columns are padded with NULs; strip them
                lines = lines.replace(b"\x00", b"")
            stream.write(lines if binary else lines.decode())

    @staticmethod
    def empty(k: int) -> "KmerTable":
        return KmerTable(k, np.zeros((0, words_per_key(k)), np.uint32),
                         np.zeros((0,), np.int64))

    @staticmethod
    def from_fused(k: int, fused: np.ndarray, counts: np.ndarray
                   ) -> "KmerTable":
        """Aggregate unsorted fused-uint64 (key, count) pairs."""
        fu, merged = reduce_fused(fused, counts)
        return KmerTable(k, unfuse_words(fu, k), merged)

    @staticmethod
    def from_device_runs(k: int, keys, counts) -> "KmerTable":
        """Aggregate one device count step's output: keys int64 (any
        shape, SENTINEL_KEY on invalid lanes), counts of the same shape
        (0 on sentinels and later in-segment duplicates)."""
        fused, live_counts = device_run_pairs(keys, counts)
        return KmerTable.from_fused(k, fused, live_counts)

    @staticmethod
    def from_pairs(k: int, keys: np.ndarray, counts: np.ndarray
                   ) -> "KmerTable":
        """Aggregate unsorted (key words, count) pairs into a sorted
        unique table: one sort + run-sum over the fused uint64 keys."""
        check_k(k)
        W = words_per_key(k)
        keys = np.asarray(keys, dtype=np.uint32)
        if keys.ndim == 2 and keys.shape[0] and keys.shape[1] != W:
            # a silent reshape would merge or split adjacent keys
            raise ValueError(f"key width {keys.shape[1]} != {W} words "
                             f"for {k} bases")
        counts = np.asarray(counts, dtype=np.int64)
        if len(counts) == 0:
            return KmerTable.empty(k)
        return KmerTable.from_fused(k, fuse_words(keys, k), counts)

    def filter_count_range(self, min_count: int = 1,
                           max_count: int | None = None) -> "KmerTable":
        """Keep k-mers with min_count <= count (<= max_count)."""
        keep = self.counts >= min_count
        if max_count is not None:
            keep &= self.counts <= max_count
        return KmerTable(self.k, self.keys[keep], self.counts[keep])

    def save(self, path: str) -> None:
        """Persist as .npz (k, keys, counts): the same fields as
        kmer_tpu's, so either package loads the other's files."""
        np.savez_compressed(path, k=np.int64(self.k), keys=self.keys,
                            counts=self.counts)

    @staticmethod
    def load(path: str) -> "KmerTable":
        with np.load(path) as z:
            return KmerTable(int(z["k"]), z["keys"], z["counts"])

    def __eq__(self, other) -> bool:
        """Equal keys and counts.  Any table with the same k/keys/counts
        fields compares, so `port_table == kmer_tpu_table` works."""
        if not all(hasattr(other, a) for a in ("k", "keys", "counts")):
            return NotImplemented
        return (self.k == other.k
                and self.keys.shape == other.keys.shape
                and bool(np.all(self.keys == other.keys))
                and bool(np.all(self.counts == other.counts)))


def device_run_pairs(keys, counts) -> tuple[np.ndarray, np.ndarray]:
    """Live (count > 0) lanes of a device step's output as unsorted
    (uint64 key, int64 count) pairs.  The sentinel lanes all carry count
    0, so the filter drops them too."""
    keys = np.asarray(keys).reshape(-1)
    counts = np.asarray(counts).reshape(-1)
    live = counts > 0
    return keys[live].view(np.uint64), counts[live].astype(np.int64)


class TableAccumulator:
    """Buffered-flush aggregation of a stream of tables: parts are
    buffered and merged in ONE from_pairs once the buffered row count
    crosses `flush_pairs`; a merge that barely compacts backs the
    threshold off x4, which keeps the number of merges logarithmic.
    Aggregation does not depend on order, so any schedule gives the
    same table."""

    def __init__(self, n_bases: int, flush_pairs: int = 8 << 20):
        self.n_bases = n_bases
        self.flush_pairs = flush_pairs
        self._parts: list[KmerTable] = []
        self._buffered = 0

    def add(self, t: KmerTable) -> None:
        if t.num_distinct == 0:
            return
        self._parts.append(t)
        self._buffered += t.num_distinct
        if self._buffered >= self.flush_pairs and len(self._parts) > 1:
            self._merge()

    def _merge(self) -> None:
        n_in = self._buffered
        merged = KmerTable.from_pairs(
            self.n_bases,
            np.concatenate([p.keys for p in self._parts], axis=0),
            np.concatenate([p.counts for p in self._parts]))
        if merged.num_distinct > 0.75 * n_in:
            self.flush_pairs *= 4
        self._parts = [merged]
        self._buffered = merged.num_distinct

    def result(self) -> KmerTable:
        """Final merged table (an empty one carries the right width)."""
        if not self._parts:
            return KmerTable.empty(self.n_bases)
        if len(self._parts) > 1:
            self._merge()
        return self._parts[0]
