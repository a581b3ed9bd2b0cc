"""End-to-end counting pipeline: FASTA -> device batches -> KmerTable.

Single-device pipeline, sort mode.  Each batch goes to the device 2-bit
packed and runs ONE kernel (ops/kernels/fused_extract: extraction,
canonical key, validity and the in-segment collapse); its outputs come
back to pinned host buffers while the device runs the next batch, and
the host aggregates one batch behind the device.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from ..config import KmerConfig
from ..io.fasta import iter_batches, iter_parse_chunks, parse_seqs
from ..ops.kernels.fused_extract import fused_extract_count
from ..utils import stagetime
from ..utils.stats import StatsLogger, Timer, prefetch_iter
from .table import (KmerTable, TableAccumulator, device_run_pairs,
                    reduce_fused, unfuse_words)

# positions per in-segment collapse: only changes how many duplicate
# pairs reach the host, never the table
SEG = 2


def resolve_device(device) -> torch.device:
    """torch.device for `device`; "cuda" with no usable GPU raises (the
    pipeline never moves work to the CPU behind the caller's back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to count with the "
                           "plain torch version")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def count_step_sort(codes: torch.Tensor, lengths: torch.Tensor,
                    limits: torch.Tensor, *, k: int, canonical: bool,
                    mask_ambiguous: bool = False, packed_width: int = 0):
    """One device batch, sort mode: (keys (P_pad, B) int64, counts
    (P_pad, B) int8) under the partial-aggregation contract (equal keys
    may recur; the host sums them).  Runs on the device the tensors lie
    on."""
    return fused_extract_count(codes, lengths, limits, k,
                               canonical=canonical,
                               mask_ambiguous=mask_ambiguous, seg=SEG,
                               packed_width=packed_width)


class _Readback:
    """One batch's outputs on their way to the host.  On a GPU they are
    copied into pinned buffers on the compute stream, and an event marks
    the end of the copy, so the host can wait for THIS batch alone while
    the device works on the next."""

    def __init__(self, keys: torch.Tensor, counts: torch.Tensor):
        if keys.device.type == "cuda":
            self.keys = torch.empty(keys.shape, dtype=keys.dtype,
                                    pin_memory=True)
            self.counts = torch.empty(counts.shape, dtype=counts.dtype,
                                      pin_memory=True)
            self.keys.copy_(keys, non_blocking=True)
            self.counts.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.keys, self.counts, self.event = keys, counts, None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """Live (uint64 key, int64 count) pairs; call after wait()."""
        return device_run_pairs(self.keys.numpy(), self.counts.numpy())


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # from pageable memory the copy is staged before this returns, so the
    # numpy buffer may be reused at once
    return torch.from_numpy(a).to(dev, non_blocking=True)


def count_codes(codes: np.ndarray, offsets: np.ndarray, cfg: KmerConfig,
                stats: StatsLogger | None = None,
                device="cuda") -> KmerTable:
    """Count k-mers of pre-parsed records (the codes/offsets contract of
    io.fasta.parse_seqs) on `device` ("cuda" or "cpu").

    The device step is dispatched asynchronously and the host
    aggregation runs one batch behind: while the device counts batch i,
    the host merges batch i-1's pairs."""
    dev = resolve_device(device)
    log = stats or StatsLogger(enabled=cfg.stats)
    k = cfg.n_bases
    n_batches = 0

    # buffered flush schedule: batch pairs are bulk-merged (one sort over
    # many batches) on a background thread once flush_pairs accumulate;
    # re-merging a growing table every batch would be O(total^2)
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    aggregated: set[int] = set()       # ids of sorted-unique parts
    buffered = 0
    flush_pairs = 8 << 20
    merge_pool = cf.ThreadPoolExecutor(max_workers=1)
    inflight: list[cf.Future] = []

    def do_merge(snapshot):
        n_in = sum(len(c) for _, c in snapshot)
        merged = reduce_fused(np.concatenate([f for f, _ in snapshot]),
                              np.concatenate([c for _, c in snapshot]))
        return merged, n_in

    def harvest() -> None:
        nonlocal buffered, flush_pairs
        if inflight:
            with stagetime.stage("host_merge"):
                merged, n_in = inflight.pop().result()
            aggregated.add(id(merged))
            if len(merged[1]) > 0.75 * n_in:
                # barely compacted: later flushes would re-sort it, so
                # back off hard (x4 keeps the merge count logarithmic)
                flush_pairs *= 4
            parts.insert(0, merged)
            buffered += len(merged[1])

    def flush() -> None:
        nonlocal parts, buffered
        harvest()
        if len(parts) > 1:
            inflight.append(merge_pool.submit(do_merge, parts))
            parts = []
            buffered = 0

    def take(rb: _Readback) -> None:
        nonlocal buffered
        with stagetime.stage("readback"):
            rb.wait()
        with stagetime.stage("table_build"):
            part = rb.pairs()
        parts.append(part)
        buffered += len(part[1])
        if buffered >= flush_pairs:
            flush()

    # 2-bit packed host-to-device copy; the ambiguity code needs a third
    # bit, so skip-invalid mode ships u8 rows
    packed = cfg.packed_transfer and not cfg.skip_invalid
    # tight batch width: this chunk's longest record rounded up to 32,
    # floored at the window span; longer records split with overlap
    # seams, so the table does not depend on the width
    max_len = cfg.max_read_len
    if len(offsets) > 1:
        longest = int(np.max(np.diff(offsets)))
        max_len = min(max_len, -(-max(longest, cfg.window_span) // 32) * 32)
    pending = None
    try:
        for batch in stagetime.stage_iter("batch_prep", iter_batches(
                codes, offsets, batch_reads=cfg.batch_reads,
                max_len=max_len, overlap=cfg.overlap, packed=packed)):
            with Timer() as t:
                with stagetime.stage("dispatch"):
                    bc = batch.codes.view(np.int32) if packed else batch.codes
                    keys, counts = count_step_sort(
                        _to_device(bc, dev), _to_device(batch.lengths, dev),
                        _to_device(batch.start_limits, dev), k=k,
                        canonical=cfg.canonical,
                        mask_ambiguous=cfg.skip_invalid,
                        packed_width=batch.packed_width)
                    rb = _Readback(keys, counts)
                if pending is not None:
                    take(pending)
                pending = rb
            n_batches += 1
            log.log("batch", i=n_batches,
                    reads=int((batch.lengths > 0).sum()),
                    secs=round(t.elapsed, 4))
        if pending is not None:
            take(pending)
        harvest()
        if len(parts) > 1 or (parts and id(parts[0]) not in aggregated):
            with stagetime.stage("host_merge"):
                parts = [do_merge(parts)[0]]
    finally:
        merge_pool.shutdown(wait=True)
    if parts:
        fused, cts = parts[0]
        table = KmerTable(k, unfuse_words(fused, k), cts)
    else:
        table = KmerTable.empty(k)
    log.log("done", batches=n_batches, reads=len(offsets) - 1,
            distinct=table.num_distinct, total=table.total)
    return table


def count_fasta(path: str, cfg: KmerConfig | None = None, *, device="cuda",
                **cfg_kw) -> KmerTable:
    """Count k-mers of a FASTA or FASTQ file (auto-detected; plain, gzip
    or BGZF) on `device`.  `count_fasta(p, k=21, device="cpu")` works."""
    return count_files([path], cfg, device=device, **cfg_kw)


def count_files(paths, cfg: KmerConfig | None = None, *, device="cuda",
                **cfg_kw) -> KmerTable:
    """Count k-mers across several FASTA/FASTQ files into one table.

    Ingest is chunked (cfg.ingest_chunk_bases), so peak host memory does
    not grow with the corpus; the native parser fills chunk i+1 on a
    background thread while chunk i counts."""
    cfg = cfg or KmerConfig()
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    resolve_device(device)
    acc = TableAccumulator(cfg.n_bases)
    for p in paths:
        if cfg.ingest_chunk_bases > 0:
            chunks = stagetime.stage_iter("ingest", prefetch_iter(
                iter_parse_chunks(p, max_bases=cfg.ingest_chunk_bases,
                                  allow_ambiguous=cfg.skip_invalid,
                                  min_qual=cfg.min_qual)))
        else:
            with stagetime.stage("ingest"):
                codes, offsets = parse_seqs(p,
                                            allow_ambiguous=cfg.skip_invalid,
                                            min_qual=cfg.min_qual)
            chunks = [(codes, offsets, -1)]
        for codes, offsets, _cursor in chunks:
            acc.add(count_codes(codes, offsets, cfg, device=device))
    with stagetime.stage("host_merge"):
        return acc.result()
