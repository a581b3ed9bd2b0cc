"""Host FASTA/FASTQ ingest and batching into fixed-shape device batches.

Parsing and batch filling run in the native C++ library compiled from
the port's native/fasta_pack.cpp (g++ and zlib, built at first use by
utils/build).  FASTA or FASTQ, plain, gzip or BGZF, is auto-detected.

Output contract of parse_seqs: (codes, offsets)
  codes:   (total_bases,) uint8 2-bit codes (4 = ambiguous base when
           allow_ambiguous), all records concatenated
  offsets: (n_records+1,) int64, record r = codes[offsets[r]:offsets[r+1]]
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..ops.encode import InvalidBaseError

_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def load_native():
    """Load (building if needed) the native parser; raises if it cannot
    be built."""
    global _lib
    if _lib is not None:
        return _lib
    from ..utils.build import NATIVE_DIR, build_cdll
    lib = build_cdll(os.path.join(NATIVE_DIR, "fasta_pack.cpp"),
                     "fasta_pack", extra_link=("-lz",))
    i, i64, cp, vp = ctypes.c_int, ctypes.c_int64, ctypes.c_char_p, \
        ctypes.c_void_p
    scan_mt = [cp, i, i, _i64p, _i64p, cp, i64]
    parse_mt = [cp, i, i, _u8p, i64, _i64p, i64, _i64p, _i64p, cp, i64]
    lib.fasta_scan_mt.restype = i
    lib.fasta_scan_mt.argtypes = scan_mt
    lib.fasta_parse_mt.restype = i
    lib.fasta_parse_mt.argtypes = parse_mt
    lib.fastq_scan_mt.restype = i
    lib.fastq_scan_mt.argtypes = scan_mt
    lib.fastq_parse_mt.restype = i
    # fastq parse entry points take min_qual after allow_ambiguous
    lib.fastq_parse_mt.argtypes = parse_mt[:2] + [i] + parse_mt[2:]
    lib.fill_batch.restype = None
    lib.fill_batch.argtypes = [_u8p, _i64p, i64, _u8p, _i32p, _i32p, i64,
                               i64]
    lib.fill_batch_packed.restype = None
    lib.fill_batch_packed.argtypes = [_u8p, _i64p, i64, _u32p, _i32p, _i32p,
                                      i64, i64, i64]
    lib.ingest_open.restype = vp
    lib.ingest_open.argtypes = [cp, i64]
    lib.ingest_close.restype = None
    lib.ingest_close.argtypes = [vp]
    lib.ingest_tell.restype = i64
    lib.ingest_tell.argtypes = [vp]
    lib.bgzf_usize.restype = i64
    lib.bgzf_usize.argtypes = [cp]
    lib.bgzf_cache_clear.restype = None
    lib.bgzf_cache_clear.argtypes = []
    chunk = [vp, i, _u8p, i64, _i64p, i64, i64, _i64p, _i64p,
             ctypes.POINTER(i), cp, i64]
    lib.fasta_chunk.restype = i
    lib.fasta_chunk.argtypes = chunk
    lib.fastq_chunk.restype = i
    lib.fastq_chunk.argtypes = chunk[:2] + [i] + chunk[2:]
    _lib = lib
    return lib


def native_loaded() -> bool:
    return _lib is not None


_ERRCODES = {
    -1: "cannot open file",
    -2: "malformed FASTA",
    -3: "invalid base",
    -4: "internal buffer overflow",
}


def _raise(path: str, rc: int, err) -> None:
    msg = err.value.decode() or _ERRCODES.get(rc, f"error {rc}")
    raise (InvalidBaseError if rc == -3 else ValueError)(f"{path}: {msg}")


def _parse_threads() -> int:
    """Threads of the whole-file parse: KMER_TPU_PARSE_THREADS (the CLI's
    --threads) when set, else up to 8 cores."""
    env = os.environ.get("KMER_TPU_PARSE_THREADS")
    if env:
        return max(1, int(env))
    return min(os.cpu_count() or 1, 8)


def _check_min_qual(allow_ambiguous: bool, min_qual: int) -> None:
    """Quality masking writes the ambiguous code into the stream, which a
    strict (allow_ambiguous=False) caller would misread as a base."""
    if min_qual > 0 and not allow_ambiguous:
        raise ValueError("min_qual masks bases to the ambiguous code; "
                         "pass allow_ambiguous=True")


def _parse_whole(path: str, fmt: str, allow_ambiguous: bool,
                 min_qual: int) -> tuple[np.ndarray, np.ndarray]:
    """Multithreaded whole-file parse: a scan pass sizes the buffers,
    a parse pass fills them."""
    lib = load_native()
    t = _parse_threads()
    amb = 1 if allow_ambiguous else 0
    if fmt == "fastq":
        scan = lib.fastq_scan_mt

        def parse(p, a, *rest):
            return lib.fastq_parse_mt(p, a, min_qual, *rest)
    else:
        scan, parse = lib.fasta_scan_mt, lib.fasta_parse_mt
    err = ctypes.create_string_buffer(256)
    nrec, nbase = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = scan(path.encode(), amb, t, ctypes.byref(nrec), ctypes.byref(nbase),
              err, 256)
    if rc != 0:
        _raise(path, rc, err)
    codes = np.empty(max(int(nbase.value), 1), dtype=np.uint8)
    offsets = np.empty(int(nrec.value) + 1, dtype=np.int64)
    rc = parse(path.encode(), amb, t, codes.ctypes.data_as(_u8p), codes.size,
               offsets.ctypes.data_as(_i64p), offsets.size,
               ctypes.byref(nrec), ctypes.byref(nbase), err, 256)
    if rc != 0:
        _raise(path, rc, err)
    # BGZF inputs: both passes shared one cached decompressed buffer
    lib.bgzf_cache_clear()
    return codes[: int(nbase.value)], offsets


def detect_format(path: str) -> str:
    """"fasta" or "fastq" from the first non-whitespace byte.  An empty
    (or all-whitespace) file counts as an empty FASTA."""
    with open(path, "rb") as f:
        head = f.read(256)
    if head[:2] == b"\x1f\x8b":
        import gzip
        import zlib
        try:
            with gzip.open(path, "rb") as f:
                head = f.read(256)
        except (zlib.error, EOFError) as e:
            raise ValueError(f"{path}: corrupt gzip stream ({e})")
    for b in head:
        if b in b" \t\r\n":
            continue
        if b == ord(">"):
            return "fasta"
        if b == ord("@"):
            return "fastq"
        raise ValueError(f"{path}: cannot detect FASTA/FASTQ format")
    return "fasta"


def parse_seqs(path: str, allow_ambiguous: bool = False,
               min_qual: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Auto-detecting whole-file parser (FASTA or FASTQ, plain, gzip or
    BGZF).  min_qual applies to FASTQ only."""
    fmt = detect_format(path)
    if fmt == "fastq":
        _check_min_qual(allow_ambiguous, min_qual)
    return _parse_whole(path, fmt, allow_ambiguous, min_qual)


def iter_parse_chunks(path: str, *, max_bases: int = 256 << 20,
                      allow_ambiguous: bool = False, start_cursor: int = 0,
                      min_qual: int = 0):
    """Yield (codes, offsets, next_cursor) windows of whole records.

    Peak host memory is ~max_bases plus one record, independent of the
    corpus size.  A plain (or BGZF) file that fits one window takes the
    multithreaded whole-file parse instead, from cursor 0 only.
    next_cursor is the uncompressed byte offset after the window, at a
    record boundary: passed back as start_cursor it resumes the parse
    there without re-reading the bytes before it (pipeline/streaming's
    checkpoints)."""
    fmt = detect_format(path)
    if fmt == "fastq":
        _check_min_qual(allow_ambiguous, min_qual)
    lib = load_native()
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        plain = fh.read(2) != b"\x1f\x8b"
    if not plain:
        # BGZF: the MT parsers inflate its blocks in parallel, so it
        # qualifies when the UNCOMPRESSED size fits (-1 = plain gzip)
        usize = int(lib.bgzf_usize(path.encode()))
        plain, size = usize >= 0, usize
    if start_cursor == 0 and plain and size <= max_bases:
        codes, offsets = _parse_whole(path, fmt, allow_ambiguous, min_qual)
        if len(offsets) > 1:            # the chunked path yields nothing
            yield codes, offsets, size  # for empty files; match it
        return
    yield from _iter_chunks_native(lib, path, fmt, max_bases,
                                   allow_ambiguous, start_cursor, min_qual)


def scan_record_offsets(path: str, *, max_bases: int = 256 << 20,
                        allow_ambiguous: bool = False) -> np.ndarray:
    """The (n_records + 1,) int64 record offsets of parse_seqs(path)[1],
    from one chunked pass that keeps no codes: peak memory is one chunk
    plus 8 bytes a record.  The multi-process count derives its record
    partition from it (parallel/multihost)."""
    lens = [np.diff(offsets) for _, offsets, _ in iter_parse_chunks(
        path, max_bases=max_bases, allow_ambiguous=allow_ambiguous)]
    out = np.zeros(sum(len(x) for x in lens) + 1, np.int64)
    if len(out) > 1:
        np.cumsum(np.concatenate(lens), out=out[1:])
    return out


def _iter_chunks_native(lib, path, fmt, max_bases, allow_ambiguous,
                        start_cursor, min_qual):
    if fmt == "fastq":
        def fn(h, amb, *rest):
            return lib.fastq_chunk(h, amb, min_qual, *rest)
    else:
        fn = lib.fasta_chunk
    amb = 1 if allow_ambiguous else 0
    cap = max_bases + (16 << 20)          # slack for one straddling record
    rec_cap = max(max_bases // 32, 1 << 16)
    cursor = start_cursor
    h = lib.ingest_open(path.encode(), cursor)
    if not h:
        raise ValueError(f"{path}: cannot open (offset {cursor})")
    try:
        err = ctypes.create_string_buffer(256)
        eof = ctypes.c_int(0)
        while not eof.value:
            codes = np.empty(cap, np.uint8)
            offsets = np.empty(rec_cap + 1, np.int64)
            nrec, nbase = ctypes.c_int64(0), ctypes.c_int64(0)
            rc = fn(h, amb, codes.ctypes.data_as(_u8p), codes.size,
                    offsets.ctypes.data_as(_i64p), offsets.size, max_bases,
                    ctypes.byref(nrec), ctypes.byref(nbase),
                    ctypes.byref(eof), err, 256)
            if rc == -4:
                # one record (or the record count) outgrew the buffers:
                # reopen at the last good cursor with doubled capacity
                lib.ingest_close(h)
                cap *= 2
                rec_cap *= 2
                h = lib.ingest_open(path.encode(), cursor)
                if not h:
                    raise ValueError(f"{path}: cannot reopen at {cursor}")
                eof.value = 0
                continue
            if rc != 0:
                _raise(path, rc, err)
            cursor = lib.ingest_tell(h)
            if nrec.value == 0:
                break
            yield (codes[:int(nbase.value)], offsets[:int(nrec.value) + 1],
                   cursor)
    finally:
        lib.ingest_close(h)


# ---------------------------------------------------------------------------
# Batching: ragged records -> fixed-shape (B, L) device batches.
# ---------------------------------------------------------------------------

@dataclass
class Batch:
    codes: np.ndarray        # (B, L) uint8 zero-padded, or — packed
                             # transfer — (B, ceil(L/16)) uint32 with 16
                             # bases/word, first base in the most
                             # significant pair (4x smaller H2D)
    lengths: np.ndarray      # (B,) int32 — valid prefix length per row
    start_limits: np.ndarray  # (B,) int32 — row owns window starts o < limit
    packed_width: int = 0    # L when codes is packed, else 0


def pack_batch_codes(codes_u8: np.ndarray) -> np.ndarray:
    """Numpy twin of the native packer: (B, L) uint8 codes -> (B,
    ceil(L/16)) uint32, 16 bases a word, first base in the most
    significant pair."""
    B, L = codes_u8.shape
    Lw = (L + 15) // 16
    padded = np.zeros((B, Lw * 16), np.uint8)
    padded[:, :L] = codes_u8 & 3
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    lanes = padded.reshape(B, Lw, 16).astype(np.uint32)
    return (lanes << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)


def segment_records(offsets: np.ndarray, max_len: int, overlap: int
                    ) -> np.ndarray:
    """Split records longer than max_len into windows with `overlap`
    shared bases.  A non-final segment owns only window starts o < step
    (= max_len - overlap); the final one owns everything it can fit, so
    every window of span <= overlap+1 is extracted exactly once.

    Returns (n_segments, 3) int64: [start, end, start_limit)."""
    assert 0 <= overlap < max_len
    lens = np.diff(offsets)
    if len(lens) and (lens <= max_len).all():
        return np.stack([offsets[:-1], offsets[1:],
                         np.full(len(lens), max_len, np.int64)], axis=1)
    spans = []
    step = max_len - overlap
    for r in range(len(offsets) - 1):
        s, e = int(offsets[r]), int(offsets[r + 1])
        if e - s <= max_len:
            spans.append((s, e, max_len))
            continue
        p = s
        while p < e:
            q = min(p + max_len, e)
            spans.append((p, q, max_len if q == e else step))
            if q == e:
                break
            p += step
    return np.asarray(spans, dtype=np.int64).reshape(-1, 3)


def batch_from_spans(codes: np.ndarray, spans_chunk: np.ndarray, *,
                     batch_reads: int, max_len: int,
                     packed: bool = False) -> Batch:
    """ONE fixed-shape Batch from <= batch_reads [start, end, limit)
    spans into `codes`; rows past the spans are zero-length padding."""
    m = len(spans_chunk)
    B = batch_reads
    assert m <= B, (m, B)
    lib = load_native()
    lens = np.empty((B,), dtype=np.int32)
    lims = np.empty((B,), dtype=np.int32)
    sp = np.ascontiguousarray(spans_chunk, dtype=np.int64)
    cc = codes if codes.size else np.zeros(1, np.uint8)
    if packed:
        Lw = (max_len + 15) // 16
        out = np.empty((B, Lw), dtype=np.uint32)
        lib.fill_batch_packed(cc.ctypes.data_as(_u8p),
                              sp.ctypes.data_as(_i64p), m,
                              out.ctypes.data_as(_u32p),
                              lens.ctypes.data_as(_i32p),
                              lims.ctypes.data_as(_i32p), B, Lw, max_len)
        return Batch(out, lens, lims, packed_width=max_len)
    out = np.empty((B, max_len), dtype=np.uint8)
    lib.fill_batch(cc.ctypes.data_as(_u8p), sp.ctypes.data_as(_i64p), m,
                   out.ctypes.data_as(_u8p), lens.ctypes.data_as(_i32p),
                   lims.ctypes.data_as(_i32p), B, max_len)
    return Batch(out, lens, lims)


def iter_batches(codes: np.ndarray, offsets: np.ndarray, *,
                 batch_reads: int, max_len: int, overlap: int,
                 start_batch: int = 0, packed: bool = False
                 ) -> Iterator[Batch]:
    """Yield fixed-shape batches.  The final batch is padded to full B
    with zero-length rows, so every device step sees one shape.
    `start_batch` skips the first batches without building them (a
    checkpoint's resume).  `packed` emits 2-bit uint32-packed rows
    (pure-ACGT codes only)."""
    spans = segment_records(offsets, max_len, overlap)
    n = len(spans)
    for i in range(start_batch * batch_reads, max(n, 1), batch_reads):
        yield batch_from_spans(codes, spans[i:i + batch_reads],
                               batch_reads=batch_reads, max_len=max_len,
                               packed=packed)
        if n == 0:
            break
