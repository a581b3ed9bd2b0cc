"""Reference-parity mode: byte-exact reproduction of the reference's
stdout -- the sorted dump, duplicates retained, of every gapped L+R
chunk -- with the md5 contract SAMPLE_FASTA_MD5 on tests/data/sample.fasta.

Every mode runs the gapped count step (kernel K3 on a GPU) per batch:

- parity_dump (default): count the chunks into one table with the
  gapped pipeline, then expand the sorted unique table back into
  repeated lines.  np.repeat(decode(keys), counts) IS the sorted
  multiset dump: equal chunks are adjacent by construction.
- KMER_TPU_PARITY=multiset: each batch's chunk pairs are sorted on the
  device (kernel K6 on a GPU), expanded to lines on the host, and the
  per-batch sorted dumps merge with one host sort.
- parity_dump_stream: bounded host memory; per-batch sorted lines go to
  order-preserving spill partitions, sorted one partition at a time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile

import numpy as np
import torch

from ..config import KmerConfig
from ..io.fasta import iter_parse_chunks, parse_seqs
from ..ops.count import sort_words
from ..ops.encode import decode_key_words_to_lines, pairs_to_u32
from .count import (_to_device, count_fasta, device_batches,
                    gapped_step_sort, resolve_device)
from .streaming import route_partition

# The measured contract for the reference's bundled corpus.
SAMPLE_FASTA_MD5 = "1a4ca1e7d4f2e70253aadca10d8351b4"


def _parity_cfg(cfg: KmerConfig | None, device) -> KmerConfig:
    """The parity default: on a GPU with on-device compaction, so the
    readback scales with distinct chunks (kmer_tpu's default on its
    accelerator); on the CPU without, as kmer_tpu off its accelerator."""
    cfg = cfg or KmerConfig(gapped=True, batch_reads=256, max_read_len=512,
                            compact=resolve_device(device).type == "cuda")
    return cfg if cfg.gapped else cfg.replace(gapped=True)


def parity_step(codes: torch.Tensor, lengths: torch.Tensor,
                limits: torch.Tensor, *, c_min: int, c_max: int,
                l_len: int = 27, r_len: int = 27, packed_width: int = 0):
    """One batch on the device its tensors lie on: every gapped chunk as
    (hi, lo, counts) 1-D int64, sorted lexicographically by (hi, lo)
    (kernel K6 on a GPU, ops/count.sort_words), then by count (positive
    int8 counts: 31 bits is a safe promise).  Equal chunks collapsed
    within a segment carry their count; expanding each row `counts`
    times gives the batch's sorted multiset."""
    hi, lo, counts = gapped_step_sort(codes, lengths, limits, c_min=c_min,
                                      c_max=c_max, l_len=l_len, r_len=r_len,
                                      packed_width=packed_width)
    live = counts.reshape(-1) > 0
    return tuple(sort_words([hi.reshape(-1)[live], lo.reshape(-1)[live],
                             counts.reshape(-1)[live].to(torch.int64)],
                            bits=(2 * l_len, 2 * r_len, 31)))


def _sorted_batches(codes: np.ndarray, offsets: np.ndarray,
                    cfg: KmerConfig, dev: torch.device):
    """(key words, counts) on the host for each device batch, sorted."""
    packed = cfg.packed_transfer and not cfg.skip_invalid
    for batch in device_batches(codes, offsets, cfg, packed):
        bc = batch.codes.view(np.int32) if packed else batch.codes
        hi, lo, counts = parity_step(
            _to_device(bc, dev), _to_device(batch.lengths, dev),
            _to_device(batch.start_limits, dev), c_min=cfg.c_min,
            c_max=cfg.c_max, l_len=cfg.l_len, r_len=cfg.r_len,
            packed_width=batch.packed_width)
        yield (pairs_to_u32(hi.cpu().numpy(), lo.cpu().numpy(), cfg.l_len,
                            cfg.r_len), counts.cpu().numpy())


def _lines(words: np.ndarray, n_bases: int) -> np.ndarray:
    """(M, W) key words -> (M,) |S{n_bases+1} newline-terminated lines."""
    return np.frombuffer(decode_key_words_to_lines(words, n_bases),
                         dtype=f"S{n_bases + 1}")


def parity_dump(path: str, cfg: KmerConfig | None = None, *,
                device="cuda") -> bytes:
    """The reference's sorted chunk dump of a FASTA file, as bytes:
    count + expand, or the per-batch multiset sort when
    KMER_TPU_PARITY=multiset."""
    cfg = _parity_cfg(cfg, device)
    if os.environ.get("KMER_TPU_PARITY") == "multiset":
        return _parity_dump_multiset(path, cfg, device)
    table = count_fasta(path, cfg, device=device)
    return np.repeat(_lines(table.keys, cfg.n_bases), table.counts).tobytes()


def _parity_dump_multiset(path: str, cfg: KmerConfig, device) -> bytes:
    """Per-batch device sort of every chunk; the per-batch sorted dumps
    merge with one host sort of the lines."""
    dev = resolve_device(device)
    codes, offsets = parse_seqs(path)
    parts = [np.repeat(_lines(words, cfg.n_bases), counts)
             for words, counts in _sorted_batches(codes, offsets, cfg, dev)]
    if not parts:
        return b""
    merged = np.concatenate(parts)
    if len(parts) > 1:
        merged.sort(kind="stable")
    return merged.tobytes()


def parity_dump_stream(path: str, out, cfg: KmerConfig | None = None,
                       spill_dir: str | None = None, partitions: int = 64,
                       *, device="cuda") -> None:
    """The sorted dump with bounded host memory, written to the binary
    stream `out`, byte-identical to parity_dump.

    Each batch's sorted lines go to per-partition spill files by the
    order-preserving top key bits (streaming.route_partition: partition
    p's lines all sort before partition p+1's); pass 2 sorts one
    partition at a time and streams it out.  Peak memory is about one
    ingest chunk plus the largest partition; ingest is chunked
    (cfg.ingest_chunk_bases) at record boundaries."""
    cfg = _parity_cfg(cfg, device)
    dev = resolve_device(device)
    n_bases = cfg.n_bases
    own_dir = spill_dir is None
    spill_dir = spill_dir or tempfile.mkdtemp(prefix="kmer_parity_")
    os.makedirs(spill_dir, exist_ok=True)
    paths = [os.path.join(spill_dir, f"lines_{p:05d}.bin")
             for p in range(partitions)]
    files = [open(p, "wb") for p in paths]
    try:
        if cfg.ingest_chunk_bases > 0:
            chunks = iter_parse_chunks(path,
                                       max_bases=cfg.ingest_chunk_bases)
        else:
            chunks = iter([(*parse_seqs(path), -1)])
        for codes, offsets, _cursor in chunks:
            for words, counts in _sorted_batches(codes, offsets, cfg, dev):
                dest = route_partition(words, n_bases, partitions)
                bounds = np.searchsorted(dest, np.arange(partitions + 1))
                lines = _lines(words, n_bases)
                for p in range(partitions):
                    lo, hi = int(bounds[p]), int(bounds[p + 1])
                    if hi > lo:
                        files[p].write(np.repeat(lines[lo:hi],
                                                 counts[lo:hi]).tobytes())
        for f in files:
            f.close()
        for p in range(partitions):
            arr = np.fromfile(paths[p], dtype=f"S{n_bases + 1}")
            if arr.size:
                arr.sort(kind="stable")
                out.write(arr.tobytes())
            os.remove(paths[p])
    finally:
        for f in files:
            f.close()
        if own_dir:
            shutil.rmtree(spill_dir, ignore_errors=True)


def parity_md5(path: str, cfg: KmerConfig | None = None, *,
               device="cuda") -> str:
    return hashlib.md5(parity_dump(path, cfg, device=device)).hexdigest()
