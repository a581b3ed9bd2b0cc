"""Streaming two-pass counting with checkpoint/resume, and the
order-preserving spill routing it shares with the bounded parity dump.

Counterpart of kmer_tpu/pipeline/streaming.py.  Counting is split into
two checkpointed passes over a spill directory, so a corpus need not fit
in memory and a crash loses at most one unit of work:

  pass 1  each device batch runs the sort-mode count step count_codes
          would run for the config (kernel K1, or K3 for gapped chunks,
          or the unfused K7 routes, on a GPU); the host, one batch
          behind the device, reduces the batch's pairs to a sorted
          unique part, routes it by the top bits of the key value
          (monotone, as route_partition) and appends each partition's
          slice to its spill file.  Checkpoint unit: a batch.
          Under the device merge (pipeline/count._devmerge_ok, as
          kmer_tpu decides it) the batches merge into the device-resident
          table instead (DeviceMerge, kernel K6) and only its drains
          spill.  Checkpoint unit: a drain-commit, at the end of every
          ingest chunk, at a pause and at the end; a crash in between
          counts again the batches since the last commit.
          Over a mesh (StreamingCounter(mesh=), parallel/) each batch
          runs the distributed step instead, and the host reduces and
          spills its owners' routed pairs as a batch at a time.  The
          batches are the same, so a run paused on one mesh shape
          resumes on another, or on none.
  pass 2  per partition, the spilled records reduce to a sorted unique
          table, table_{p}.npz.  Checkpoint unit: a partition.

Routing is monotone in the key, so the partition tables concatenated in
order ARE the global sorted table.

Spill records are the port's own format: the C = fused_columns(n_bases)
fused uint64 key columns of pipeline/table.fuse_words, most significant
first (one column up to 31 bases, [high, low] for 32 to 63, ceil(W32 / 2)
beyond, W32 = words_per_key(n_bases)), then the int64 count, in native
byte order: 8 (C + 1) bytes a record at every key width.  Records of one
and two columns are those version 1 has always written, and no earlier
version-1 directory holds a wider key (its constructor refused one), so
the version stands.  kmer_tpu spills uint32 key words and uint32 counts
and drains its device table before a total reaches 2**31; int64 counts
need no such drain.  The manifest's fingerprint names the format and its
version, and a spill directory of another format or version is refused,
never misread.

Crash model: the manifest (manifest.json) is written atomically
(tmp + fsync + rename) after every unit and records the exact byte
length of every spill file; a resume truncates each file back to it, so
a torn append never reaches pass 2, and it starts the parse at the
ingest cursor of the chunk holding the next batch.  A chunk parsed again
from its cursor gets the same batch width (pipeline/count.batch_width)
and so the same batches; the fingerprint covers everything the width
depends on.  The table is the same whether the run was interrupted 0 or
N times.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import KmerConfig
from ..ops.encode import fused_columns, words_per_key
from ..ops.kernels import fused_gapped
from ..parallel import distributed
from ..parallel.distributed import route_dest
from ..parallel.mesh import pad_columns, split_batch
from ..utils import stagetime
from ..utils.stats import StatsLogger, Timer
from .count import (_devmerge_ok, _Readback, count_batches, devmerge_route,
                    dispatch_batches, iter_chunks, resolve_device, sort_step)
from .table import (KmerTable, fuse_words, reduce_fused, routed_pairs,
                    unfuse_words)

MANIFEST = "manifest.json"
SPILL_FORMAT = "kmer_tpu_torch"
# 1: fused uint64 key columns (any number) + an int64 count a record;
# tight batch widths a chunk (pipeline/count.batch_width)
SPILL_VERSION = 1


def route_partition(keys: np.ndarray, n_bases: int, n_parts: int
                    ) -> np.ndarray:
    """Order-preserving partition id of each key.

    keys: (M, W) uint32, most significant word first, no sentinels.
    Returns (M,) int64 part = top_bits * n_parts // 2**tb
    (parallel/distributed.route_dest): monotone in the key, so sorted keys
    give non-decreasing partition ids and the partitions, concatenated in
    order, stay sorted.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.shape[1] != words_per_key(n_bases):
        raise ValueError(f"{keys.shape[1]} key words for {n_bases} bases")
    return route_fused(fuse_words(keys, n_bases), n_bases, n_parts)


def route_fused(fused: np.ndarray, n_bases: int, n_parts: int) -> np.ndarray:
    """route_partition of fused keys (fuse_words' layout: (M,) uint64
    values, or (M, C) columns, most significant first, column 0 holding
    2 n_bases - 64 (C - 1) bits), by the one routing definition,
    parallel/distributed.route_dest.  The top tb <= 16 bits lie in the
    top two columns, taken as planes of n_bases - 32 (C - 1) and 32 bases
    (the second with its top bit flipped, as ops/encode stores a 32-base
    plane)."""
    if fused.ndim == 1:
        planes = (torch.from_numpy(fused.view(np.int64)),)
        bases = (n_bases,)
    else:
        C = fused.shape[1]
        planes = (torch.from_numpy(np.ascontiguousarray(fused[:, 0])
                                   .view(np.int64)),
                  torch.from_numpy((fused[:, 1] ^ np.uint64(1 << 63))
                                   .view(np.int64)))
        bases = (n_bases - 32 * (C - 1), 32)
    return route_dest(planes, bases, n_parts).numpy()


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _records(fused: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(n, cols + 1) uint64 spill records: the key columns, then the
    int64 count's bits."""
    n = len(counts)
    cols = 1 if fused.ndim == 1 else fused.shape[1]
    rec = np.empty((n, cols + 1), np.uint64)
    rec[:, :cols] = fused.reshape(n, cols)
    rec[:, cols] = np.asarray(counts, np.int64).view(np.uint64)
    return rec


def _read_records(path: str, nbytes: int, cols: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The first nbytes of a spill file: (fused keys, int64 counts)."""
    if nbytes == 0:
        rec = np.zeros((0, cols + 1), np.uint64)
    else:
        rec = np.fromfile(path, dtype=np.uint64, count=nbytes // 8)
        rec = rec.reshape(-1, cols + 1)
    fused = rec[:, 0].copy() if cols == 1 else np.ascontiguousarray(
        rec[:, :cols])
    return fused, rec[:, cols].view(np.int64).copy()


class _BatchPass:
    """Pass 1 a batch at a time: the host reduces and spills batch i - 1
    while the device counts batch i, and checkpoints after each spill,
    so the manifest names only batches whose bytes are appended."""

    def __init__(self, sc: "StreamingCounter"):
        self.sc = sc
        self.step, self.batch_pairs = sort_step(sc.cfg, sc.dev, compact=False)
        self.pending = None

    def add(self, i: int, rb) -> None:
        if self.pending is not None:
            self._take(*self.pending)
        self.pending = (i, rb)

    def _take(self, i: int, rb) -> None:
        with Timer() as t:
            with stagetime.stage("readback"):
                rb.wait()
            with stagetime.stage("table_build"):
                fused, counts = self.batch_pairs(rb)
            with stagetime.stage("host_merge"):
                fused, counts = reduce_fused(fused, counts)
            self.sc._spill(fused, counts)
            self.sc.state["pass1_next_batch"] = i + 1
            self.sc._checkpoint()
        self.sc.log.log("pass1_batch", i=i, pairs=len(counts),
                        secs=round(t.elapsed, 4))

    def commit(self, next_batch: int) -> None:
        """Spill the batch still in flight; the caller checkpoints."""
        if self.pending is not None:
            self._take(*self.pending)
            self.pending = None


class _MeshPass(_BatchPass):
    """Pass 1 over a mesh (parallel/): each batch runs the distributed
    step (the pairs step, or the sorted stream under
    KMER_TPU_MULTIHOST_STEP=legacy) and comes back as its owners' routed
    pairs; the host reduces, spills and checkpoints them as _BatchPass
    does.  The batches are the ones a run with no mesh makes (their
    columns padded for the seq axis), so a run resumes on any mesh."""

    def __init__(self, sc: "StreamingCounter"):
        self.sc, self.pending = sc, None
        mesh, cfg = sc.mesh, sc.cfg
        run = distributed.make_step(mesh, cfg)
        bases = cfg.plane_bases

        def step(codes_d, lengths_d, limits_d, pw):
            codes_d, pw = pad_columns(codes_d, pw, mesh.n_seq)
            batch = split_batch(mesh, codes_d, lengths_d, limits_d, pw)
            return _Readback(tuple(distributed.gather_owners(run(batch))))

        def batch_pairs(rb):
            *words, counts = rb.host()
            return routed_pairs(words, counts, bases)
        self.step, self.batch_pairs = step, batch_pairs


class _DeviceMergePass:
    """Pass 1 through the device-resident table: batches merge on the
    device; a drain appends to the spill files (DeviceMerge's sink, which
    also takes the drains the state's budget forces), and only a commit
    moves the manifest's cursor.  DeviceMerge grows its state to hold a
    pending group after a drain, so no merge drops a key."""

    def __init__(self, sc: "StreamingCounter"):
        self.sc = sc
        self.step, self.dm = devmerge_route(sc.cfg, sc.dev,
                                            sink=lambda part: sc._spill(*part))

    def add(self, i: int, out) -> None:
        self.dm.add(*out)
        self.sc.log.log("pass1_batch", i=i, distinct_bound=self.dm.bound)

    def commit(self, next_batch: int) -> None:
        """Merge what is buffered, drain the table into the spill files
        and move the cursor to next_batch; the caller checkpoints."""
        self.dm.flush()
        self.dm.drain()
        state = self.sc.state
        state["pass1_next_batch"] = max(state["pass1_next_batch"], next_batch)


class StreamingCounter:
    """Two-pass spill counter over one FASTA/FASTQ file, on `device`
    ("cuda" or "cpu"; the tables do not depend on it, so a run may
    resume on the other), or with `mesh` (parallel/mesh, this process's
    positions) over the mesh's devices.

        sc = StreamingCounter(fasta, cfg, spill_dir)
        sc.run()                     # both passes, resumable
        StreamingCounter(fasta, cfg, spill_dir, mesh=make_mesh(4, 1,
                         devices=["cuda:0"] * 4))   # pass 1 over a mesh
        for p, table in sc.partition_tables(): ...
        table = sc.final_table()     # the global sorted table
    """

    def __init__(self, fasta: str, cfg: KmerConfig, spill_dir: str,
                 stats: StatsLogger | None = None, device="cuda", mesh=None):
        if cfg.partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {cfg.partitions}")
        self.fasta = fasta
        self.cfg = cfg
        self.dir = spill_dir
        self.mesh = mesh
        if mesh is None:
            self.dev = resolve_device(device)
        else:
            self._check_mesh(mesh)
            self.dev = mesh.devices[0]
        self.log = stats or StatsLogger(enabled=cfg.stats)
        self.P = cfg.partitions
        self.n_bases = cfg.n_bases
        # fused key columns a record (pipeline/table.fuse_words)
        self.cols = fused_columns(self.n_bases)
        os.makedirs(spill_dir, exist_ok=True)
        self.manifest_path = os.path.join(spill_dir, MANIFEST)
        self.state = self._load_or_init_state()

    def _check_mesh(self, mesh) -> None:
        """A mesh runs in this process (no other process reads its
        batches), over the batches a run with no mesh makes, and is not
        combined with the device merge (as in kmer_tpu)."""
        cfg = self.cfg
        if mesh.world > 1:
            raise ValueError("StreamingCounter(mesh=) runs one process; "
                             f"got a mesh over {mesh.world} processes")
        if cfg.batch_reads % mesh.n_data:
            raise ValueError(f"batch_reads={cfg.batch_reads} not divisible "
                             f"by mesh data axis {mesh.n_data}")
        if (os.environ.get("KMER_TPU_DEVMERGE") == "1"
                or cfg.device_merge == "on"):
            raise ValueError("the device merge is not combined with a mesh: "
                             "pass 1 over a mesh spills each batch's routed "
                             "pairs; set device_merge to auto or off")

    def _fingerprint(self) -> dict:
        c = self.cfg
        st = os.stat(self.fasta)
        return {
            "format": SPILL_FORMAT, "version": SPILL_VERSION,
            "fasta": os.path.abspath(self.fasta),
            "fasta_size": st.st_size, "fasta_mtime_ns": st.st_mtime_ns,
            "k": c.k, "canonical": c.canonical,
            "gapped": c.gapped, "partitions": c.partitions,
            "skip_invalid": c.skip_invalid, "min_qual": c.min_qual,
            "seed_mask": c.seed_mask,
            "l_len": c.l_len, "r_len": c.r_len,
            "c_min": c.c_min, "c_max": c.c_max,
            # batch indices within a chunk follow from these: the chunk
            # boundaries (ingest_chunk_bases) and each chunk's batch
            # width (max_read_len, the window span above, the gapped
            # kernel's widest row) and rows a batch
            "ingest_chunk_bases": c.ingest_chunk_bases,
            "batch_reads": c.batch_reads, "max_read_len": c.max_read_len,
            "gapped_max_row": fused_gapped.MAX_ROW if c.gapped else 0,
        }

    def _load_or_init_state(self) -> dict:
        fp = self._fingerprint()
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                state = json.load(f)
            old = state.get("fingerprint", {})
            fmt = (old.get("format", "kmer_tpu"), old.get("version"))
            if fmt != (SPILL_FORMAT, SPILL_VERSION):
                raise ValueError(
                    f"spill dir {self.dir} holds spill format {fmt[0]} "
                    f"version {fmt[1]}, not {SPILL_FORMAT} version "
                    f"{SPILL_VERSION} (its records differ); use a fresh "
                    "directory")
            if old != fp:
                raise ValueError(
                    f"spill dir {self.dir} holds a different run "
                    f"(config/input changed); use a fresh directory")
            return state
        state = {
            "fingerprint": fp,
            "pass1_next_batch": 0,
            # the ingest cursor of the chunk holding pass1_next_batch and
            # the global index of that chunk's first batch: a resume
            # parses from there
            "pass1_cursor": 0,
            "pass1_cursor_batch": 0,
            "pass1_done": False,
            "part_bytes": [0] * self.P,
            "pass2_done": [False] * self.P,
        }
        _atomic_write_json(self.manifest_path, state)
        return state

    def _part_path(self, p: int) -> str:
        return os.path.join(self.dir, f"part_{p:05d}.bin")

    def _table_path(self, p: int) -> str:
        return os.path.join(self.dir, f"table_{p:05d}.npz")

    def _checkpoint(self) -> None:
        _atomic_write_json(self.manifest_path, self.state)

    def _truncate_to_manifest(self) -> None:
        """Undo the appends after the last checkpoint (a crash mid-batch
        or between drain-commits)."""
        for p in range(self.P):
            path = self._part_path(p)
            want = self.state["part_bytes"][p]
            have = os.path.getsize(path) if os.path.exists(path) else 0
            if have > want:
                with open(path, "r+b") as f:
                    f.truncate(want)
            elif have < want:
                raise ValueError(f"spill file {path} holds {have} bytes, "
                                 f"the manifest {want}")

    # ---------------------------------------------------------- pass 1

    def run_pass1(self, max_batches: int | None = None) -> None:
        """Pass 1; `max_batches` bounds this call's batches (a pause, for
        tests and cooperative preemption): call again to go on.  Ingest
        is chunked (cfg.ingest_chunk_bases), and a resume starts the
        parse at the checkpointed chunk's cursor."""
        if self.state["pass1_done"]:
            return
        self._truncate_to_manifest()
        if max_batches is not None and max_batches < 1:
            return
        cfg = self.cfg
        start = self.state["pass1_next_batch"]
        cursor = self.state["pass1_cursor"]
        global_i = self.state["pass1_cursor_batch"]
        if self.mesh is not None:
            route = _MeshPass(self)
        elif (cfg.effective_mode == "sort" and cfg.sort_group_keys > 0
              and not cfg.compact and _devmerge_ok(cfg, self.dev)):
            route = _DeviceMergePass(self)
        else:
            route = _BatchPass(self)
        n_done = 0
        for codes, offsets, next_cur in iter_chunks([self.fasta], cfg,
                                                    start_cursor=cursor,
                                                    cursors=True):
            n_in = count_batches(offsets, cfg)
            skip = start - global_i
            if not 0 <= skip <= n_in:
                raise ValueError(f"manifest batch {start} lies outside the "
                                 f"chunk of batches [{global_i}, "
                                 f"{global_i + n_in}) at its cursor")
            for i, (_, out) in enumerate(dispatch_batches(
                    codes, offsets, cfg, self.dev, route.step, self.log,
                    start_batch=skip), start=start):
                route.add(i, out)
                start = i + 1
                n_done += 1
                if max_batches is not None and n_done >= max_batches:
                    route.commit(start)
                    self._checkpoint()
                    return
            # the cursor skips this chunk's bytes on a resume, so its
            # batches are spilled first, in the same checkpoint
            route.commit(start)
            global_i += n_in
            if next_cur > 0:
                self.state["pass1_cursor"] = next_cur
                self.state["pass1_cursor_batch"] = global_i
            self._checkpoint()
        self.state["pass1_done"] = True
        self._checkpoint()
        self.log.log("pass1_done", batches=self.state["pass1_next_batch"])

    def _spill(self, fused: np.ndarray, counts: np.ndarray) -> None:
        """Append a sorted unique part's records to the partition files.
        Routing is monotone, so the partition ids are non-decreasing and
        one searchsorted cuts the part."""
        if len(counts) == 0:
            return
        with stagetime.stage("spill"):
            dest = route_fused(fused, self.n_bases, self.P)
            bounds = np.searchsorted(dest, np.arange(self.P + 1))
            rec = _records(fused, counts)
            for p in range(self.P):
                lo, hi = int(bounds[p]), int(bounds[p + 1])
                if lo == hi:
                    continue
                with open(self._part_path(p), "ab") as f:
                    rec[lo:hi].tofile(f)
                self.state["part_bytes"][p] += (hi - lo) * rec.shape[1] * 8

    # ---------------------------------------------------------- pass 2

    def run_pass2(self) -> None:
        if not self.state["pass1_done"]:
            raise RuntimeError("pass 1 incomplete; run_pass1() first")
        for p in range(self.P):
            if self.state["pass2_done"][p]:
                continue
            with Timer() as t:
                with stagetime.stage("spill_read"):
                    fused, counts = _read_records(
                        self._part_path(p), self.state["part_bytes"][p],
                        self.cols)
                with stagetime.stage("host_merge"):
                    fused, counts = reduce_fused(fused, counts)
                with stagetime.stage("table_write"):
                    tmp = self._table_path(p) + ".tmp.npz"
                    np.savez(tmp, keys=unfuse_words(fused, self.n_bases),
                             counts=counts)
                    os.replace(tmp, self._table_path(p))
            self.state["pass2_done"][p] = True
            self._checkpoint()
            self.log.log("pass2_part", p=p, distinct=len(counts),
                         secs=round(t.elapsed, 4))
        self.log.log("pass2_done", partitions=self.P)

    # ---------------------------------------------------------- driver

    def run(self) -> None:
        self.run_pass1()
        self.run_pass2()

    def partition_tables(self):
        """Yield (p, KmerTable) in partition (= global key) order."""
        for p in range(self.P):
            if not self.state["pass2_done"][p]:
                raise RuntimeError(f"partition {p} not counted yet; run()")
            with np.load(self._table_path(p)) as z:
                yield p, KmerTable(self.n_bases, z["keys"], z["counts"])

    def final_table(self) -> KmerTable:
        """The partition tables concatenated: the global sorted table."""
        keys, counts = [], []
        for _, t in self.partition_tables():
            keys.append(t.keys)
            counts.append(t.counts)
        if not keys:
            return KmerTable.empty(self.n_bases)
        return KmerTable(self.n_bases, np.concatenate(keys, axis=0),
                         np.concatenate(counts))

    def multiplicity_histogram(self) -> dict[int, int]:
        """The corpus's k-mer spectrum, a partition at a time: partitions
        hold disjoint keys, so their spectra add."""
        out: dict[int, int] = {}
        for _, t in self.partition_tables():
            for mult, ndis in t.multiplicity_histogram().items():
                out[mult] = out.get(mult, 0) + ndis
        return out

    def write_tsv(self, stream) -> None:
        """The global table as TSV, a partition at a time."""
        for _, t in self.partition_tables():
            t.write_tsv(stream)

    def cleanup(self, keep_tables: bool = True) -> None:
        """Delete the spill files (and the partition tables and the
        manifest unless keep_tables) after a completed run."""
        for p in range(self.P):
            path = self._part_path(p)
            if os.path.exists(path):
                os.remove(path)
        if not keep_tables:
            for p in range(self.P):
                t = self._table_path(p)
                if os.path.exists(t):
                    os.remove(t)
            if os.path.exists(self.manifest_path):
                os.remove(self.manifest_path)


def stream_count_fasta(path: str, cfg: KmerConfig | None = None,
                       spill_dir: str | None = None, *, device="cuda",
                       **cfg_kw) -> KmerTable:
    """Two-pass streaming count of one file on `device`; resumable
    through `spill_dir`."""
    if spill_dir is None:
        raise ValueError("spill_dir is required for streaming")
    cfg = cfg or KmerConfig()
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    sc = StreamingCounter(path, cfg, spill_dir, device=device)
    sc.run()
    return sc.final_table()
