"""Host-side k-mer count table: sorted unique keys + counts.

KmerTable stores the same (M, W) uint32 most-significant-first key words
as kmer_tpu.pipeline.table.KmerTable (ops/encode layout), so two tables
compare with ==, write the same TSV and save the same .npz in both
packages.  Aggregation works on keys FUSED into uint64: one (M,) column
for W <= 2 (up to 31 bases), else an (M, ceil(W / 2)) most-significant-
first matrix (two columns up to 63 bases; kmer_tpu's fused columns).  A
fused key is the key value itself, so the k <= 31 device output (one
int64) needs no conversion, a pair (hi, lo) -- gapped, or a key of 32 to
63 bases -- converts with two shifts (ops/encode.pairs_to_value), and
wider keys' planes by ops/encode.planes_to_chunks.  Past two columns the
host merge is one np.lexsort, as kmer_tpu's.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..ops.encode import (SENTINEL_KEY, check_n_bases, chunks_to_u32,
                          decode_key_words, encode_seq, key_words_from_codes,
                          pairs_to_value, planes_to_chunks, revcomp_str,
                          u32_to_chunks, word_bases, words_per_key)


def _fused(chunks) -> np.ndarray:
    """uint64 value chunks, least significant first -> the fused layout:
    (M,) for one chunk, else (M, C) most significant first."""
    return chunks[0] if len(chunks) == 1 else np.stack(chunks[::-1], axis=1)


def _chunks(fused: np.ndarray) -> list[np.ndarray]:
    """Inverse of _fused."""
    if fused.ndim == 1:
        return [fused]
    return [fused[:, c] for c in range(fused.shape[1] - 1, -1, -1)]


def fuse_words(keys: np.ndarray, k: int) -> np.ndarray:
    """(M, W) uint32 key words -> (M,) uint64 key values (W <= 2) or
    (M, ceil(W / 2)) uint64 columns, most significant first (W >= 3)."""
    W = words_per_key(k)
    keys = np.ascontiguousarray(keys, dtype=np.uint32).reshape(-1, W)
    if W == 1:
        return keys[:, 0].astype(np.uint64)
    if W == 2 and sys.byteorder == "little":
        # the uint64 view reads (w0 | w1 << 32); a 32-bit rotate swaps it
        v = keys.view(np.uint64).reshape(-1)
        return (v >> np.uint64(32)) | (v << np.uint64(32))
    return _fused(u32_to_chunks(keys, k))


def unfuse_words(fused: np.ndarray, k: int) -> np.ndarray:
    """Inverse of fuse_words: uint64 values -> (M, W) uint32."""
    W = words_per_key(k)
    if W == 2 and sys.byteorder == "little":
        rot = (fused >> np.uint64(32)) | (fused << np.uint64(32))
        return np.ascontiguousarray(rot.view(np.uint32).reshape(-1, 2))
    return chunks_to_u32(_chunks(np.asarray(fused, np.uint64)), k)


def planes_to_fused(planes, bases) -> np.ndarray:
    """int64 key planes of a layout (ops/encode; bases: each plane's
    bases) -> fused keys of the sum(bases)-base key."""
    return _fused(planes_to_chunks(planes, bases))


def _void_view(keys: np.ndarray) -> np.ndarray:
    """(M, W) uint32 -> (M,) void{4W} big-endian: byte order is word
    order."""
    be = np.ascontiguousarray(keys.astype(">u4"))
    return be.view(np.dtype((np.void, be.shape[1] * 4))).reshape(-1)


def reduce_fused(fused: np.ndarray, counts: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Unsorted (fused key, int64 count) pairs -> (sorted unique keys,
    summed counts).  Large inputs go to the native bucket-parallel
    sort-reduce (pipeline/nativeagg); small ones to one numpy sort."""
    counts = np.asarray(counts, dtype=np.int64)
    if len(counts) == 0:
        return fused[:0], np.zeros(0, np.int64)
    from .nativeagg import aggregate_fused
    nat = aggregate_fused(fused, counts)
    if nat is not None:
        return nat
    if fused.ndim == 1:
        order = np.argsort(fused)          # unstable is fine: equal keys
        fs = fused[order]                  # are identical
        new_run = np.empty(len(fs), bool)
        new_run[0] = True
        np.not_equal(fs[1:], fs[:-1], out=new_run[1:])
    else:
        # the last key np.lexsort takes is the primary one
        order = np.lexsort(_chunks(fused))
        fs = fused[order]
        new_run = np.empty(len(fs), bool)
        new_run[0] = True
        np.any(fs[1:] != fs[:-1], axis=1, out=new_run[1:])
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
        """Aggregate unsorted fused (key, count) pairs."""
        fu, merged = reduce_fused(fused, counts)
        return KmerTable(k, unfuse_words(fu, k), merged)

    @staticmethod
    def from_dense(hist: np.ndarray, k: int) -> "KmerTable":
        """Dense 4**k histogram (the bin is the key value) -> the sparse
        sorted table of its non-zero bins."""
        hist = np.asarray(hist)
        nz = np.flatnonzero(hist)
        W = words_per_key(k)
        keys = np.zeros((nz.size, W), np.uint32)
        keys[:, W - 1] = nz.astype(np.uint32)
        return KmerTable(k, keys, hist[nz].astype(np.int64))

    @staticmethod
    def from_compact(n_bases: int, keys: np.ndarray, counts: np.ndarray
                     ) -> "KmerTable":
        """Aggregate one compacted batch's records (ops/kernels/compact,
        rows [0, total)): fused keys, int64 or uint64, in reduce_fused's
        layout, so no per-record conversion."""
        return KmerTable.from_fused(n_bases, np.asarray(keys).view(np.uint64),
                                    counts)

    @staticmethod
    def from_device_runs(k: int, keys, counts) -> "KmerTable":
        """Aggregate one device count step's output: keys int64 (any
        shape, SENTINEL_KEY on invalid lanes), counts of the same shape
        (0 on sentinels and later in-segment duplicates)."""
        fused, live_counts = device_run_pairs(keys, counts)
        return KmerTable.from_fused(k, fused, live_counts)

    @staticmethod
    def from_routed_pairs(n_bases: int, words, counts,
                          bases=None) -> "KmerTable":
        """Aggregate a distributed step's routed pairs (parallel/
        distributed): words the int64 key planes of the layout `bases`
        (each plane's bases; default ops/encode.word_bases(n_bases), a
        gapped step's KmerConfig.plane_bases), counts int64; dead lanes
        (count 0, or the sentinel key) dropped."""
        return KmerTable.from_fused(n_bases, *routed_pairs(
            words, counts, word_bases(n_bases) if bases is None else bases))

    @staticmethod
    def from_pairs(k: int, keys: np.ndarray, counts: np.ndarray
                   ) -> "KmerTable":
        """Aggregate unsorted (key words, count) pairs into a sorted
        unique table: one sort + run-sum over the fused uint64 keys."""
        check_n_bases(k)
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

    def _check_k(self, other: "KmerTable") -> None:
        if self.k != other.k:
            raise ValueError(f"table k mismatch: {self.k} vs {other.k}")

    def merge(self, other: "KmerTable") -> "KmerTable":
        """Every key of either table, counts added where a key is in
        both."""
        self._check_k(other)
        if other.num_distinct == 0:
            return self
        if self.num_distinct == 0:
            return other
        return KmerTable.from_pairs(
            self.k, np.concatenate([self.keys, other.keys], axis=0),
            np.concatenate([self.counts, other.counts]))

    def union(self, other: "KmerTable") -> "KmerTable":
        """Sum-union (KMC tools' union): merge()."""
        return self.merge(other)

    def _probe(self, other: "KmerTable") -> tuple[np.ndarray, np.ndarray]:
        """For each of self's keys: (hit, idx) into other's sorted keys,
        by one searchsorted over the big-endian void views (other must
        hold at least one key)."""
        va, vb = _void_view(self.keys), _void_view(other.keys)
        idx = np.minimum(np.searchsorted(vb, va), len(vb) - 1)
        return vb[idx] == va, idx

    def intersect(self, other: "KmerTable") -> "KmerTable":
        """Keys in both tables, count = min(self, other)."""
        self._check_k(other)
        if self.num_distinct == 0 or other.num_distinct == 0:
            return KmerTable.empty(self.k)
        hit, idx = self._probe(other)
        keep = np.flatnonzero(hit)
        return KmerTable(self.k, self.keys[keep],
                         np.minimum(self.counts[keep],
                                    other.counts[idx[keep]]))

    def subtract(self, other: "KmerTable",
                 counters: bool = True) -> "KmerTable":
        """counters=True (KMC's counters_subtract): self's count minus
        other's, keys at <= 0 dropped.  counters=False (kmers_subtract):
        every key present in `other` dropped, whatever its count."""
        self._check_k(other)
        if self.num_distinct == 0 or other.num_distinct == 0:
            return self
        hit, idx = self._probe(other)
        if not counters:
            keep = ~hit
            return KmerTable(self.k, self.keys[keep], self.counts[keep])
        new = self.counts - np.where(hit, other.counts[idx], 0)
        keep = new > 0
        return KmerTable(self.k, self.keys[keep], new[keep])

    def compare(self, other: "KmerTable") -> dict:
        """Exact Jaccard index and containment each way over DISTINCT
        keys, with the shared and per-side tallies."""
        self._check_k(other)
        na, nb = self.num_distinct, other.num_distinct
        if na == 0 or nb == 0:
            inter = 0
        else:
            hit, _ = self._probe(other)
            inter = int(hit.sum())
        union = na + nb - inter
        return {
            "k": self.k,
            "distinct_a": na, "distinct_b": nb, "distinct_shared": inter,
            "jaccard": inter / union if union else 1.0,
            "containment_a_in_b": inter / na if na else 1.0,
            "containment_b_in_a": inter / nb if nb else 1.0,
        }

    def filter_min_count(self, min_count: int) -> "KmerTable":
        """Drop k-mers with count < min_count."""
        return self.filter_count_range(min_count)

    def filter_count_range(self, min_count: int = 1,
                           max_count: int | None = None) -> "KmerTable":
        """Keep k-mers with min_count <= count (<= max_count)."""
        keep = self.counts >= min_count
        if max_count is not None:
            keep &= self.counts <= max_count
        return KmerTable(self.k, self.keys[keep], self.counts[keep])

    def get(self, kmer: str, canonical: bool = False) -> int:
        """Count of one k-mer, 0 if absent; canonical=True (a table built
        with canonical counting) looks up min(kmer, revcomp) instead."""
        return int(self.get_many([kmer], canonical=canonical)[0])

    def get_many(self, kmers: list[str],
                 canonical: bool = False) -> np.ndarray:
        """Counts of a list of k-mers, 0 where absent, by one searchsorted
        (get()'s canonical=)."""
        if not kmers:
            return np.zeros((0,), np.int64)
        for km in kmers:
            if len(km) != self.k:
                raise ValueError(
                    f"expected a {self.k}-mer, got {len(km)} bases")
        if canonical:
            kmers = [min(km, revcomp_str(km)) for km in kmers]
        q = key_words_from_codes(np.stack([encode_seq(km) for km in kmers]),
                                 self.k)
        if self.num_distinct == 0:
            return np.zeros((len(kmers),), np.int64)
        hit, idx = KmerTable(self.k, q, np.zeros(len(q)))._probe(self)
        return np.where(hit, self.counts[idx], 0).astype(np.int64)

    def top(self, n: int) -> list[tuple[str, int]]:
        """The n most frequent k-mers, count-descending then key order."""
        if self.num_distinct == 0:
            return []
        order = np.argsort(-self.counts, kind="stable")[:n]
        return list(zip(decode_key_words(self.keys[order], self.k),
                        self.counts[order].tolist()))

    def multiplicity_histogram(self) -> dict[int, int]:
        """{count: number of distinct keys with that count}, the k-mer
        spectrum (`histo`)."""
        if self.num_distinct == 0:
            return {}
        vals, freq = np.unique(self.counts, return_counts=True)
        return {int(v): int(f) for v, f in zip(vals, freq)}

    def save(self, path: str) -> None:
        """Persist as .npz (k, keys, counts): the same fields as
        kmer_tpu's, so either package loads the other's files."""
        np.savez_compressed(path, k=np.int64(self.k), keys=self.keys,
                            counts=self.counts)

    @staticmethod
    def load(path: str) -> "KmerTable":
        """A table saved by either package, of any key width."""
        with np.load(path) as z:
            k = int(z["k"])
            check_n_bases(k)
            return KmerTable(k, z["keys"], z["counts"])

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


def gapped_run_pairs(hi, lo, counts, r_len: int, n_bases: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """device_run_pairs for (hi, lo) int64 pairs -- the gapped step's, or
    keys of 32 to 63 bases (r_len = n_bases - 31) -- : the live lanes as
    fused key values (fuse_words' layout for n_bases)."""
    counts = np.asarray(counts).reshape(-1)
    live = counts > 0
    vhi, vlo = pairs_to_value(np.asarray(hi).reshape(-1)[live],
                              np.asarray(lo).reshape(-1)[live], r_len)
    fused = vlo if words_per_key(n_bases) <= 2 else np.stack([vhi, vlo], 1)
    return fused, counts[live].astype(np.int64)


def plane_run_pairs(planes, counts, bases) -> tuple[np.ndarray, np.ndarray]:
    """device_run_pairs for the int64 key planes of any layout (bases:
    each plane's bases, ops/encode): the live lanes as fused key
    values."""
    if len(planes) == 1:
        return device_run_pairs(planes[0], counts)
    if len(planes) == 2:
        return gapped_run_pairs(planes[0], planes[1], counts, bases[1],
                                sum(bases))
    counts = np.asarray(counts).reshape(-1)
    live = counts > 0
    return (planes_to_fused([np.asarray(p).reshape(-1)[live]
                             for p in planes], bases),
            counts[live].astype(np.int64))


def routed_pairs(words, counts, bases) -> tuple[np.ndarray, np.ndarray]:
    """The live lanes of routed int64 key planes of the layout `bases`
    (host arrays or CPU tensors) as unsorted fused (key, int64 count)
    pairs (KmerTable.from_routed_pairs)."""
    words = [np.asarray(w).reshape(-1) for w in words]
    counts = np.asarray(counts).reshape(-1)
    return plane_run_pairs(words,
                           np.where(words[0] == SENTINEL_KEY, 0, counts),
                           bases)


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
