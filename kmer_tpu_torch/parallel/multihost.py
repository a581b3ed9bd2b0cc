"""Multi-process counting over torch.distributed.

Counterpart of kmer_tpu/parallel/multihost.py.  Every process runs the
same program: initialize() joins the process group (NCCL for CUDA, gloo
for the CPU); each process parses ITS OWN contiguous slice of the
records (host_record_range: a pure function of the record count and the
process count, no coordination), cuts each of its batches over its mesh
positions (global_batch), and runs the distributed count step
(parallel/distributed) whose exchange crosses the group.  Each process
aggregates only the keys its positions own (its owner ranges), and one
all-gather at the end hands every process the global table.

Determinism: the record ranges depend on (n_records, process count)
alone, and a key's owner on its value alone, so the table is bit-identical
for every process count and mesh shape.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import comm
from .mesh import Mesh, make_mesh, process_device, split_batch

_ENV_GROUP = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Join the process group, over tcp://coordinator_address with the
    given size and rank, or from the launcher's environment (torchrun's
    MASTER_ADDR, RANK, WORLD_SIZE): NCCL when `device` is CUDA, gloo
    otherwise.  A no-op for num_processes == 1, for no arguments with
    none of that environment, and inside a group already joined.  An
    explicit request that fails raises."""
    import torch.distributed as dist
    if num_processes == 1:
        return
    explicit = (coordinator_address, num_processes, process_id) != (
        None, None, None)
    if dist.is_initialized() or not (
            explicit or any(v in os.environ for v in _ENV_GROUP)):
        return                 # joined already, or one process
    cuda = torch.device(device).type == "cuda"
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize needs coordinator_address, "
                             "num_processes and process_id together")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    dist.init_process_group("nccl" if cuda else "gloo", **kw)
    if cuda:
        torch.cuda.set_device(process_device(device))


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_record_range(n_records: int, process_id: int | None = None,
                      process_count: int | None = None) -> tuple[int, int]:
    """[start, end) of the records THIS process parses: contiguous blocks,
    the remainder spread over the first processes."""
    rank, world = _rank_world()
    pid = rank if process_id is None else process_id
    pc = world if process_count is None else process_count
    base, rem = divmod(n_records, pc)
    start = pid * base + min(pid, rem)
    return start, start + base + (1 if pid < rem else 0)


def global_batch(mesh: Mesh, local_rows: dict, packed_width: int = 0):
    """This process's batch rows {"codes", "lengths", "limits"} (every
    process passes the same row count; pad with zero-length rows) cut
    over its mesh positions (mesh.split_batch)."""
    return split_batch(mesh, local_rows["codes"], local_rows["lengths"],
                       local_rows["limits"], packed_width)


def _iter_host_batches_chunked(path: str, cfg, s: int, e: int, B_loc: int,
                               max_len: int | None = None,
                               packed: bool = False):
    """This process's fixed-shape batches of records [s, e) from one
    chunked re-parse: a rolling (codes, spans) buffer, so peak memory is
    one ingest chunk plus one batch.  The buffer drops what earlier
    batches consumed once a chunk, not once a batch, so a batch costs
    its own spans only."""
    from ..io.fasta import batch_from_spans, iter_parse_chunks, \
        segment_records
    max_len = cfg.max_read_len if max_len is None else max_len
    buf = np.zeros(0, np.uint8)
    spans = np.zeros((0, 3), np.int64)
    rec_i = 0
    for codes, offsets, _cur in iter_parse_chunks(
            path, max_bases=cfg.ingest_chunk_bases,
            allow_ambiguous=cfg.skip_invalid, min_qual=cfg.min_qual):
        n_in = len(offsets) - 1
        lo, hi = max(s - rec_i, 0), min(e - rec_i, n_in)
        rec_i += n_in
        if hi <= lo:
            if rec_i >= e:
                break                    # past this process's range
            continue
        sub_off = offsets[lo:hi + 1]
        base = int(spans[0, 0]) if len(spans) else buf.size
        kept = buf.size - base
        sp = segment_records(sub_off - sub_off[0], max_len, cfg.overlap)
        buf = np.concatenate([buf[base:], codes[sub_off[0]:sub_off[-1]]])
        spans = np.concatenate([spans - np.array([[base, base, 0]]),
                                sp + np.array([[kept, kept, 0]])])
        i = 0
        while len(spans) - i >= B_loc:
            yield batch_from_spans(buf, spans[i:i + B_loc],
                                   batch_reads=B_loc, max_len=max_len,
                                   packed=packed)
            i += B_loc
        spans = spans[i:]
    if len(spans):
        yield batch_from_spans(buf, spans, batch_reads=B_loc,
                               max_len=max_len, packed=packed)


def local_owner_positions(mesh: Mesh) -> list[int]:
    """The mesh positions (routed-pair owner ids, distributed.route_dest)
    of THIS process: the key ranges its pre-gather table covers."""
    return list(mesh.local)


def _allgather_tables(table, n_bases: int, mesh: Mesh):
    """ONE final exchange of the processes' partial tables: the global
    table, the same on every process.  Counts stay int64.  The partials
    hold disjoint owner ranges in process order, so their concatenation
    is already sorted."""
    from ..ops.encode import words_per_key
    from ..pipeline.table import KmerTable
    W = words_per_key(n_bases)
    rows = np.empty((table.num_distinct, W + 1), np.int64)
    rows[:, :W] = table.keys
    rows[:, W] = table.counts
    got = np.concatenate(comm.all_gather_host(mesh, rows))
    return KmerTable(n_bases, np.ascontiguousarray(got[:, :W], np.uint32),
                     np.ascontiguousarray(got[:, W]))


def count_fasta_multihost(path: str, cfg=None, gather: bool = True,
                          mesh: Mesh | None = None, device="cuda",
                          **cfg_kw):
    """Count one FASTA/FASTQ file over the mesh of every process: run the
    SAME call in every process after initialize().  mesh: the default is
    one position a process on its device (process_device(device)); a
    mesh with several positions on one device runs them all in this
    process (make_mesh(4, 1, devices=["cuda:0"] * 4)).

    Ingest is memory-bounded when cfg.ingest_chunk_bases > 0: a
    lengths-only chunked scan gives every process the record partition,
    then each parses only its slice.  Every process makes the same number
    of collective steps (batch counts are aligned to the largest
    process's), and aggregates only the keys its positions own, read
    back one batch behind the device, with the single-device sort
    path's buffered background merge (pipeline/count.HostMerge).  gather:
    one final all-gather gives every process the global table; False
    returns this process's partial (its owner ranges,
    local_owner_positions).  Dense mode sums each position's int64 4**k
    table once, by one all-reduce, and every process returns the whole
    table."""
    from ..config import KmerConfig
    from ..io.fasta import (Batch, iter_batches, parse_seqs,
                            scan_record_offsets, segment_records)
    from ..pipeline.count import HostMerge, _Readback, batch_width
    from ..pipeline.table import KmerTable, routed_pairs, unfuse_words
    from ..utils import stagetime
    from . import distributed
    from .mesh import pad_columns

    cfg = cfg or KmerConfig()
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    mesh = mesh or make_mesh(devices=[process_device(device)])
    pc = mesh.world
    if cfg.batch_reads % pc:
        raise ValueError(f"batch_reads={cfg.batch_reads} must be divisible "
                         f"by process_count={pc}")
    B_loc = cfg.batch_reads // pc
    if cfg.batch_reads % mesh.n_dev:
        raise ValueError(f"batch_reads={cfg.batch_reads} must be divisible "
                         f"by device count={mesh.n_dev}")

    with stagetime.stage("ingest"):
        if cfg.ingest_chunk_bases > 0:
            codes = None
            offsets = scan_record_offsets(
                path, max_bases=cfg.ingest_chunk_bases,
                allow_ambiguous=cfg.skip_invalid)
        else:
            codes, offsets = parse_seqs(path,
                                        allow_ambiguous=cfg.skip_invalid,
                                        min_qual=cfg.min_qual)
    n_records = len(offsets) - 1
    # one row width for every process: the single-device tight width of
    # the whole corpus (the same on every process)
    dev_len = batch_width(offsets, cfg)

    def host_batches(h):
        s, e = host_record_range(n_records, h, pc)
        spans = segment_records(offsets[s:e + 1] - offsets[s], dev_len,
                                cfg.overlap)
        return -(-max(len(spans), 1) // B_loc)
    n_batches = max(host_batches(h) for h in range(pc))

    s, e = host_record_range(n_records, mesh.rank, pc)
    packed = cfg.packed_transfer and not cfg.skip_invalid
    if codes is None:
        batches = _iter_host_batches_chunked(path, cfg, s, e, B_loc,
                                             max_len=dev_len, packed=packed)
    else:
        batches = iter_batches(codes[offsets[s]:offsets[e]],
                               offsets[s:e + 1] - offsets[s],
                               batch_reads=B_loc, max_len=dev_len,
                               overlap=cfg.overlap, packed=packed)
    empty = Batch(np.zeros((B_loc, (dev_len + 15) // 16 if packed
                            else dev_len), np.uint32 if packed else np.uint8),
                  np.zeros(B_loc, np.int32), np.zeros(B_loc, np.int32),
                  packed_width=dev_len if packed else 0)

    def iter_global_batches():
        for _ in range(n_batches):
            try:
                with stagetime.stage("batch_prep"):
                    b = next(batches, empty)
            except (ValueError, OSError) as exc:
                if mesh.group is None:
                    raise
                # the others wait in this step's exchange: join it with an
                # empty batch and the fault flag, which raises everywhere
                b, mesh.fault = empty, exc
            with stagetime.stage("dispatch"):
                rows = torch.from_numpy(b.codes.view(np.int32) if packed
                                        else b.codes)
                rows, pw = pad_columns(rows, b.packed_width, mesh.n_seq)
                batch = global_batch(mesh, {"codes": rows,
                                            "lengths": b.lengths,
                                            "limits": b.start_limits}, pw)
            yield batch

    if cfg.effective_mode == "dense":
        dense = distributed.make_distributed_dense(
            mesh, k=cfg.k, canonical=cfg.canonical,
            mask_ambiguous=cfg.skip_invalid)
        for batch in iter_global_batches():
            dense.add(batch)
        comm.check_fault(mesh)
        hist = dense.reduce()
        with stagetime.stage("readback"):
            hist = hist.cpu().numpy()
        return KmerTable.from_dense(hist, cfg.k)

    step = distributed.make_step(mesh, cfg)
    bases = cfg.plane_bases
    merge = HostMerge()

    def take(rb: _Readback) -> None:
        with stagetime.stage("readback"):
            rb.wait()
        with stagetime.stage("table_build"):
            *words, counts = rb.host()
            part = routed_pairs(words, counts, bases)
        merge.add(part)

    pending = None
    try:
        for batch in iter_global_batches():
            rb = _Readback(tuple(distributed.gather_owners(step(batch))))
            if pending is not None:
                take(pending)
            pending = rb
        if pending is not None:
            take(pending)
        got = merge.result()
    finally:
        merge.close()
    # this process's partial covers exactly its positions' owner ranges;
    # an empty one carries cfg.n_bases, so gapped and spaced widths
    # survive
    local = (KmerTable(cfg.n_bases, unfuse_words(got[0], cfg.n_bases),
                       got[1]) if got is not None
             else KmerTable.empty(cfg.n_bases))
    if not gather or mesh.group is None:
        return local
    return _allgather_tables(local, cfg.n_bases, mesh)
