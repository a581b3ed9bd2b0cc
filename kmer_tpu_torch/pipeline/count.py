"""End-to-end counting pipeline: FASTA -> device batches -> KmerTable.

Single-device pipeline.  Each batch goes to the device 2-bit packed and
runs one count step:

- the fused step (the default, KMER_TPU_STEP=auto or fused): contiguous
  k-mers of up to 63 bases and spaced seeds through
  ops/kernels/fused_extract (extraction, canonical key, validity and the
  in-segment collapse in kernel K1); gapped L+R chunks through
  ops/kernels/fused_gapped (K3) when KMER_TPU_GAPPED_STEP is auto or
  fused, sort_group_keys > 0 and both windows hold at most 31 bases
  (gapped_fused);
- the unfused step (KMER_TPU_STEP=legacy, any other value, or t; every
  contiguous key over 63 bases), and the uncompacted contiguous step
  whenever cfg.sort_group_keys is 0: contiguous k-mers extracted without
  collapse (ops/kernels/extract, K7), then counted by
  ops/count.grouped_count in groups of sort_group_keys keys (K2a, K2b or
  K2c by KMER_TPU_GROUPED; K2c in strided groups of KMER_TPU_T_M keys
  under t), or, for sort_group_keys = 0, by one exact flat sort
  (ops/count.sort_count, K6);
- the gapped unfused route (every gapped step K3 does not take): K7's
  gapped lanes, then grouped_count at sort_group_keys, or sort_count at
  0.  kmer_tpu's step selection (kmer_tpu/pipeline/count.py:57-138,
  144-188, 205-238, 354-455), without its fused gapped kernel's TPU-only
  conditions (a residual uint32 word, the VMEM fit).

A key travels as the int64 planes of ops/encode, KmerConfig.plane_bases:
one word up to 31 bases, the (hi, lo) pair up to 63 (hi the first 31
bases: the gapped pair at l_len = 31), W words beyond; a gapped key as
K3's split while its windows hold at most 31 bases.  The table
(plane_run_pairs), compaction (K4), the device merge (W key words) and
the grouped counts take every layout.

Then:

- sort mode: the step's output comes back to pinned host buffers while
  the device runs the next batch, and the host aggregates one batch
  behind the device.  With compact=True the step's live lanes are first
  packed on the device into host-ready records (ops/kernels/compact) and
  only those rows cross.
- sort mode with the device merge (device_merge="on", or "auto" behind a
  probed device-to-host link slower than DEVMERGE_BREAKEVEN_GBPS; never
  with sort_group_keys = 0, as in kmer_tpu): the table stays on the
  device (ops/devmerge, sorted by kernel K6) and the host reads its
  distinct rows once (DeviceMerge).
- dense mode, k <= 8: the fused step's keys and counts go into a 4**k
  int64 histogram that stays on the device (ops/kernels/histogram) and is
  read once per corpus.  k = 9..12: the fused step, then a host
  np.add.at into a 4**k int64 table (kmer_tpu's fast-link "hybrid"), or,
  behind a link slower than utils/linkspeed.SCATTER_BREAKEVEN_GBPS, a
  device index_add_ into a 4**k int64 table read once.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np
import torch

from ..config import KmerConfig
from ..io.fasta import (iter_batches, iter_parse_chunks, parse_seqs,
                        segment_records)
from ..ops import count as count_ops
from ..ops import devmerge
from ..ops.encode import (HI_BASES, PAIR_BASES, bases_bits, gapped_bases,
                          key_planes, pair_r_len, plane_bits, word_bases)
from ..ops.kernels import compact as compact_kernel
from ..ops.kernels import fused_gapped
from ..ops.kernels import merge_reduce
from ..ops.kernels.extract import extract_gapped_keys, extract_keys
from ..ops.kernels.fused_extract import fused_extract_count
from ..ops.kernels.histogram import index_histogram
from ..utils import stagetime
from ..utils.linkspeed import d2h_gbps, dense_scatter_ok
from ..utils.stats import StatsLogger, prefetch_iter
from .table import (KmerTable, TableAccumulator, device_run_pairs,
                    plane_run_pairs, reduce_fused, unfuse_words)

# positions per in-segment collapse: only changes how many duplicate
# pairs reach the host, never the table
SEG = 2
# KMER_TPU_STEP=t: keys per strided group (KMER_TPU_T_M; kmer_tpu's
# default)
T_GROUP_KEYS = 16
# dense mode keeps a device-resident 4**k table up to this k (kernel K5
# takes indices of up to 16 bits)
DENSE_DEVICE_K_MAX = 8
# the device merge trades the per-batch readback (~10 B a lane) for its
# sorts; on a fast link the readback is cheap and the sorts are overhead
# (kmer_tpu's constant)
DEVMERGE_BREAKEVEN_GBPS = 0.5


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


def fused_step(codes: torch.Tensor, lengths: torch.Tensor,
               limits: torch.Tensor, *, k: int, canonical: bool,
               mask_ambiguous: bool = False, packed_width: int = 0,
               positions=None):
    """The fused count step (kernel K1 on a GPU): (keys (P_pad, B) int64
    -- the (hi, lo) pair of them for keys of 32 to 63 bases -- and counts
    (P_pad, B) int8) under the partial-aggregation contract (equal keys
    may recur; the host sums them).  positions: a spaced seed's k window
    offsets.  Dense mode calls it directly, whatever KMER_TPU_STEP
    says."""
    return fused_extract_count(codes, lengths, limits, k,
                               canonical=canonical,
                               mask_ambiguous=mask_ambiguous, seg=SEG,
                               packed_width=packed_width, positions=positions)


def _fused_selected() -> bool:
    """KMER_TPU_STEP auto (the default) or fused selects the fused step;
    kmer_tpu's TPU default, and the H100's."""
    return os.environ.get("KMER_TPU_STEP", "auto") in ("auto", "fused")


def gapped_fused(l_len: int, r_len: int, group_keys: int) -> bool:
    """The gapped step is K3: KMER_TPU_GAPPED_STEP auto (the default) or
    fused, the grouped partial-aggregation contract (group_keys > 0; 0
    asks for one exact flat sort) and windows of at most 31 bases
    (kmer_tpu's _gapped_fused_ok without its TPU-only conditions).  Any
    other KMER_TPU_GAPPED_STEP value (legacy) takes the unfused route."""
    return (os.environ.get("KMER_TPU_GAPPED_STEP", "auto") in ("auto",
                                                                "fused")
            and group_keys > 0 and max(l_len, r_len) <= HI_BASES)


def _t_group_keys() -> int:
    m = int(os.environ.get("KMER_TPU_T_M", T_GROUP_KEYS))
    if m < 1 or m & (m - 1):
        raise ValueError(f"KMER_TPU_T_M={m} must be a power of two")
    return m


def count_step_sort(codes: torch.Tensor, lengths: torch.Tensor,
                    limits: torch.Tensor, *, k: int, canonical: bool,
                    mask_ambiguous: bool = False, group_keys: int = 0,
                    packed_width: int = 0, positions=None):
    """One device batch, sort mode: (keys, counts) under the
    partial-aggregation contract, on the device the tensors lie on; keys
    of more than 31 bases are tuples of planes (ops/encode).  positions:
    a spaced seed's k window offsets (k the mask's popcount), or None;
    with them this is kmer_tpu's spaced_step_sort
    (kmer_tpu/pipeline/count.py:144).

    group_keys > 0 with KMER_TPU_STEP auto or fused and k <= 63: the
    fused step, (P_pad, B) int64 keys and int8 counts.  Otherwise the
    unfused step:
    extraction (K7), then group_keys == 0: one exact flat sort
    (sort_count), whatever KMER_TPU_STEP says; KMER_TPU_STEP=t: K2c over
    strided groups of KMER_TPU_T_M keys; any other value: grouped_count
    at m = group_keys (KMER_TPU_GROUPED) -- flat (N_pad,) int64 keys and
    int32 counts."""
    if group_keys > 0 and _fused_selected() and k <= PAIR_BASES:
        return fused_step(codes, lengths, limits, k=k, canonical=canonical,
                          mask_ambiguous=mask_ambiguous,
                          packed_width=packed_width, positions=positions)
    planes = [p.reshape(-1) for p in key_planes(extract_keys(
        codes, lengths, limits, k, canonical=canonical,
        mask_ambiguous=mask_ambiguous, packed_width=packed_width,
        positions=positions))]
    if group_keys == 0:
        words, counts = count_ops.sort_count(planes, bits=plane_bits(k))
    elif os.environ.get("KMER_TPU_STEP") == "t":
        words, counts = count_ops.grouped_count(planes, _t_group_keys(),
                                                backend="pallas_t")
    else:
        words, counts = count_ops.grouped_count(planes, group_keys)
    return (tuple(words) if len(words) > 1 else words[0]), counts


def gapped_step_sort(codes: torch.Tensor, lengths: torch.Tensor,
                     limits: torch.Tensor, *, c_min: int, c_max: int,
                     l_len: int = 27, r_len: int = 27,
                     mask_ambiguous: bool = False, packed_width: int = 0,
                     group_keys: int = 256):
    """One device batch of gapped L+R chunks (reference semantics: every
    chunk size c in [c_min, c_max] and offset o with o + c <= len):
    (*planes, counts) under the partial-aggregation contract, the planes
    those of ops/encode.gapped_bases.  Runs on the device the tensors lie
    on.

    gapped_fused: K3, (hi, lo (B, T_pad) int64, counts (B, T_pad) int8).
    Otherwise the unfused route: K7's gapped lanes, then grouped_count
    at m = group_keys (KMER_TPU_GROUPED), or for group_keys == 0 one
    exact flat sort (sort_count, K6) -- flat (N_pad,) int64 planes and
    int32 counts."""
    if gapped_fused(l_len, r_len, group_keys):
        return fused_gapped.fused_gapped_count(
            codes, lengths, limits, l_len=l_len, r_len=r_len, c_min=c_min,
            c_max=c_max, mask_ambiguous=mask_ambiguous, seg=SEG,
            packed_width=packed_width)
    planes = [p.reshape(-1) for p in extract_gapped_keys(
        codes, lengths, limits, l_len=l_len, r_len=r_len, c_min=c_min,
        c_max=c_max, mask_ambiguous=mask_ambiguous,
        packed_width=packed_width)]
    if group_keys == 0:
        words, counts = count_ops.sort_count(
            planes, bits=bases_bits(gapped_bases(l_len, r_len)))
    else:
        words, counts = count_ops.grouped_count(planes, group_keys)
    return (*words, counts)


def count_step_compact(codes: torch.Tensor, lengths: torch.Tensor,
                       limits: torch.Tensor, *, k: int, canonical: bool,
                       mask_ambiguous: bool = False, group_keys: int = 256,
                       packed_width: int = 0):
    """One sort-mode batch with on-device compaction: (keys (n,) int64,
    (n, 2) [vhi, vlo] for keys of 32 to 63 bases, or (n, W) words beyond,
    counts (n,) int64, total (1,) int64), rows [0, total) the batch's
    live (key, count) records (ops/kernels/compact).  The fused step
    under KMER_TPU_STEP auto or fused for k <= 63, whatever group_keys
    is; else K7, then grouped_count at m = group_keys (at least 1)."""
    if _fused_selected() and k <= PAIR_BASES:
        keys, counts = fused_step(codes, lengths, limits, k=k,
                                  canonical=canonical,
                                  mask_ambiguous=mask_ambiguous,
                                  packed_width=packed_width)
        return compact_kernel.compact(key_planes(keys), counts,
                                      r_len=pair_r_len(k), n_bases=k)
    keys = extract_keys(codes, lengths, limits, k, canonical=canonical,
                        mask_ambiguous=mask_ambiguous,
                        packed_width=packed_width)
    return count_ops.grouped_count_compact(key_planes(keys), group_keys,
                                           bases=word_bases(k))


def gapped_step_compact(codes: torch.Tensor, lengths: torch.Tensor,
                        limits: torch.Tensor, *, c_min: int, c_max: int,
                        l_len: int = 27, r_len: int = 27,
                        mask_ambiguous: bool = False, packed_width: int = 0,
                        group_keys: int = 256):
    """gapped_step_sort with on-device compaction: records of the key
    value (one uint64 column up to 31 bases, else [vhi, vlo]), or the
    words of a key of three or four planes, as count_step_compact.  K3
    under gapped_fused, else K7's gapped lanes and grouped_count at m =
    group_keys (at least 1)."""
    win = dict(c_min=c_min, c_max=c_max, l_len=l_len, r_len=r_len,
               mask_ambiguous=mask_ambiguous, packed_width=packed_width)
    if gapped_fused(l_len, r_len, group_keys):
        hi, lo, counts = gapped_step_sort(codes, lengths, limits, **win)
        return compact_kernel.compact((hi, lo), counts, r_len=r_len,
                                      n_bases=l_len + r_len)
    planes = extract_gapped_keys(codes, lengths, limits, **win)
    return count_ops.grouped_count_compact(planes, group_keys,
                                           bases=gapped_bases(l_len, r_len))


def count_step_dense(codes: torch.Tensor, lengths: torch.Tensor,
                     limits: torch.Tensor, hist: torch.Tensor, *, k: int,
                     canonical: bool, mask_ambiguous: bool = False,
                     packed_width: int = 0) -> torch.Tensor:
    """One device batch, dense mode (k <= 8): the fused step, then
    its keys weighted by their in-segment counts accumulated in place
    into `hist` ((4**k,) int64 on the batch's device); returns hist."""
    keys, counts = fused_step(codes, lengths, limits, k=k,
                              canonical=canonical,
                              mask_ambiguous=mask_ambiguous,
                              packed_width=packed_width)
    return index_histogram(keys, counts, 2 * k, out=hist)


def count_step_scatter(codes: torch.Tensor, lengths: torch.Tensor,
                       limits: torch.Tensor, table: torch.Tensor, *, k: int,
                       canonical: bool, mask_ambiguous: bool = False,
                       packed_width: int = 0) -> torch.Tensor:
    """One device batch, dense k = 9..12 on the device: the fused step,
    then its live keys weighted by their counts added in place into
    `table` ((4**k,) int64 on the batch's device) by index_add_; returns
    table."""
    keys, counts = fused_step(codes, lengths, limits, k=k,
                              canonical=canonical,
                              mask_ambiguous=mask_ambiguous,
                              packed_width=packed_width)
    counts = counts.reshape(-1).to(torch.int64)
    # dead lanes carry count 0 and the sentinel key: add 0 to bin 0
    idx = torch.where(counts > 0, keys.reshape(-1), 0)
    return table.index_add_(0, idx, counts)


def _devmerge_ok(cfg: KmerConfig | None = None, device=None) -> bool:
    """The device-merge policy: KMER_TPU_DEVMERGE=1/0 forces it, then
    cfg.device_merge "on"/"off"; "auto" is a CUDA device whose probed
    device-to-host link (utils/linkspeed.d2h_gbps) is slower than
    KMER_TPU_DEVMERGE_LINK_GBPS (default DEVMERGE_BREAKEVEN_GBPS)."""
    env = os.environ.get("KMER_TPU_DEVMERGE")
    if env in ("0", "1"):
        return env == "1"
    mode = cfg.device_merge if cfg is not None else "auto"
    if mode in ("on", "off"):
        return mode == "on"
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return False
    thr = float(os.environ.get("KMER_TPU_DEVMERGE_LINK_GBPS",
                               DEVMERGE_BREAKEVEN_GBPS))
    return d2h_gbps(dev) < thr


class DeviceMerge:
    """The device-resident table of one sort-mode run (ops/devmerge).

    add() buffers step outputs (W int64 key planes and counts, on the
    device) and merges them in one sort once about C/2 lanes have
    gathered, C the state's rows, so that each lane is sorted about
    three times however large C grows.  Before every merge of N lanes the
    state holds C >= distinct + N: a host-side bound on distinct (the
    lanes merged since the last sync) says when the true count must be
    read (the "device_sync" stage), and the state then grows, within
    devmerge.max_rows, or drains into `parts` and resets.  After a reset
    the state grows to hold the pending group whatever the budget, so no
    merge can drop a key.  KMER_TPU_DEVMERGE_ROWS fixes C (raised to one
    group's lanes): every overflow drains.

    A drain reads the distinct rows through the wire tiers and hands
    to_part(keys (d, W) int64, counts (d,) int64) to `sink`, by default
    parts.append; each part is sorted and unique, so a run with one
    drain needs no host merge (streaming's sink appends each part to its
    spill files instead).  bits: the key words' value bits, which the
    merge's sort trims its passes to (ops/kernels/sort; default 64
    each).

    `tally` counts on the host, with no device read: merges; lanes, the
    N lanes of every merge summed; rows_sorted, C + N of every merge
    summed (sentinel rows included: the rows its sort and scans read, so
    rows_sorted / lanes is the rows sorted a lane taken in); grows;
    drains; rows_drained, the distinct rows drained; reduced_on_card,
    the merges whose run totals and compaction ran the kernel
    (ops/kernels/merge_reduce; all of them on a GPU, none on the CPU)."""

    def __init__(self, n_words: int, device, to_part, *, l_len: int = 0,
                 r_len: int = 0, bits=None, sink=None):
        self.W, self.device, self.to_part = n_words, device, to_part
        self.wire = dict(l_len=l_len, r_len=r_len)
        self.bits = bits
        self.words = self.counts = None
        self.fixed = False
        self.distinct = 0          # live rows at the last sync
        self.bound = 0             # distinct <= bound
        self.d_dev = None          # distinct after the last merge (device)
        self.pend: list = []
        self.pend_lanes = 0
        self.parts: list = []
        self.sink = sink if sink is not None else self.parts.append
        self.tally = dict.fromkeys(("merges", "lanes", "rows_sorted",
                                    "grows", "drains", "rows_drained",
                                    "reduced_on_card"), 0)

    @property
    def capacity(self) -> int:
        return 0 if self.counts is None else self.counts.numel()

    def add(self, words, counts: torch.Tensor) -> None:
        self.pend.append((words, counts))
        self.pend_lanes += counts.numel()
        if self.pend_lanes >= self.capacity // 2:
            self.flush()

    def _reset(self, rows: int) -> None:
        self.words, self.counts = devmerge.empty_state(rows, self.W,
                                                       self.device)
        self.distinct = self.bound = 0
        self.d_dev = None

    def _grow(self, rows: int) -> None:
        with stagetime.stage("dispatch"), stagetime.stage("dispatch.grow"):
            self.words, self.counts = devmerge.grow_state(self.words,
                                                          self.counts, rows)
        self.tally["grows"] += 1

    def _sync(self) -> None:
        if self.d_dev is not None:
            with stagetime.stage("device_sync"):
                self.distinct = int(self.d_dev)
            self.d_dev = None
        self.bound = self.distinct

    def flush(self) -> None:
        """Merge the buffered lanes into the state."""
        N = self.pend_lanes
        if N == 0:
            self.pend = []
            return
        pow2 = 1 << (N - 1).bit_length()
        if self.words is None:
            rows = max(1 << 16, 2 * pow2)
            env = os.environ.get("KMER_TPU_DEVMERGE_ROWS")
            self.fixed = env is not None
            self._reset(max(int(env) if env else rows, pow2))
        elif self.bound + N > self.capacity:
            self._sync()
            need = self.distinct + N
            if need > self.capacity:
                cap = devmerge.max_rows(self.W)
                if not self.fixed and need <= cap:
                    self._grow(min(cap, max(2 * self.capacity,
                                            1 << (need - 1).bit_length())))
                else:
                    self.drain()
                    if N > self.capacity:
                        self._grow(pow2)
        with stagetime.stage("dispatch"), stagetime.stage("dispatch.merge"):
            bw = [torch.cat([p[0][i].reshape(-1) for p in self.pend])
                  for i in range(self.W)]
            bc = torch.cat([p[1].reshape(-1) for p in self.pend])
            launched = merge_reduce.launches
            self.words, self.counts, self.d_dev = devmerge.merge_batch(
                self.words, self.counts, bw, bc, bits=self.bits)
        self.bound += N
        self.tally["reduced_on_card"] += merge_reduce.launches - launched
        self.tally["merges"] += 1
        self.tally["lanes"] += N
        self.tally["rows_sorted"] += self.capacity + N
        self.pend, self.pend_lanes = [], 0

    def drain(self) -> None:
        """Hand the distinct rows to the sink and reset the state."""
        if self.words is None:
            return
        self._sync()
        with stagetime.stage("readback"):
            got = devmerge.fetch_state_wire(self.words, self.counts,
                                            self.distinct, **self.wire)
            if got is None:
                got = devmerge.fetch_state(self.words, self.counts,
                                           self.distinct)
        self.tally["drains"] += 1
        self.tally["rows_drained"] += len(got[1])
        if len(got[1]):
            with stagetime.stage("convert"):
                self.sink(self.to_part(*got))
        self._reset(self.capacity)

    def finish(self) -> list:
        """Merge what is buffered, drain, hand the tally to stagetime's
        counters (as `devmerge.<name>`), and return the parts."""
        self.flush()
        self.drain()
        for name, n in self.tally.items():
            stagetime.count(f"devmerge.{name}", n)
        return self.parts


class _Readback:
    """One batch's output planes on their way to the host.  On a GPU
    they are copied into pinned buffers on the compute stream, and an
    event marks the end of the copy, so the host can wait for THIS batch
    alone while the device works on the next."""

    def __init__(self, planes: tuple[torch.Tensor, ...]):
        if planes[0].device.type == "cuda":
            self.planes = tuple(torch.empty(p.shape, dtype=p.dtype,
                                            pin_memory=True) for p in planes)
            for host, dev in zip(self.planes, planes):
                host.copy_(dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.planes, self.event = planes, None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def host(self) -> list[np.ndarray]:
        """The planes as numpy arrays; call after wait()."""
        return [p.numpy() for p in self.planes]


class _CompactReadback:
    """One compacted batch (keys, counts, total) on its way to the host.
    On a GPU only the total crosses at once, into pinned memory behind an
    event; wait() then copies rows [0, total) of the records, on a side
    stream so that the next batch's kernels, queued on the compute
    stream, do not hold the copy."""

    def __init__(self, out, copy_stream=None, bases=(1,)):
        self.keys, self.counts, total = out
        self.copy_stream = copy_stream
        self.bases = bases
        if total.device.type == "cuda":
            self.total = torch.empty(1, dtype=torch.int64, pin_memory=True)
            self.total.copy_(total, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.total, self.event = total, None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
        t = int(self.total[0])
        dev = (self.keys[:t], self.counts[:t])
        if self.event is None:
            self.keys, self.counts = dev
            return
        host = [torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
                for d in dev]
        if t:
            with torch.cuda.stream(self.copy_stream):
                for h, d in zip(host, dev):
                    h.copy_(d, non_blocking=True)
            self.copy_stream.synchronize()
        self.keys, self.counts = host

    def pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(fused uint64 keys, int64 counts): views of the records of one
        or two planes, fused here from three or four (bases: each
        plane's bases); call after wait()."""
        return (compact_kernel.records_fused(self.keys.numpy(), self.bases),
                self.counts.numpy())


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # from pageable memory the copy is staged before this returns, so the
    # numpy buffer may be reused at once
    return torch.from_numpy(a).to(dev, non_blocking=True)


def batch_width(offsets: np.ndarray, cfg: KmerConfig,
                span: int | None = None) -> int:
    """The tight row width of one parsed chunk: its longest record
    rounded up to 32, floored at the window span (c_max for gapped
    chunks, or `span`), capped at cfg.max_read_len and, when the gapped
    step is K3 (gapped_fused), at K3's widest row.  It depends on the
    chunk (and the step) alone, so a chunk parsed again from the same
    cursor gets the same width and the same batches."""
    span = span or cfg.window_span
    max_len = cfg.max_read_len
    if len(offsets) > 1:
        longest = int(np.max(np.diff(offsets)))
        max_len = min(max_len, -(-max(longest, span) // 32) * 32)
    if cfg.gapped and gapped_fused(cfg.l_len, cfg.r_len,
                                   cfg.sort_group_keys):
        max_len = min(max_len, fused_gapped.MAX_ROW)
    return max_len


def count_batches(offsets: np.ndarray, cfg: KmerConfig) -> int:
    """How many device batches device_batches makes of one chunk (one,
    all padding, for a chunk without records)."""
    n = len(segment_records(offsets, batch_width(offsets, cfg), cfg.overlap))
    return max(-(-n // cfg.batch_reads), 1)


def device_batches(codes: np.ndarray, offsets: np.ndarray, cfg: KmerConfig,
                   packed: bool, span: int | None = None,
                   start_batch: int = 0):
    """The fixed-shape device batches of one parsed chunk, at its
    batch_width, from batch `start_batch` on.  Longer records split with
    overlap seams (span - 1 bases), so the table does not depend on the
    width."""
    span = span or cfg.window_span
    return iter_batches(codes, offsets, batch_reads=cfg.batch_reads,
                        max_len=batch_width(offsets, cfg, span),
                        overlap=span - 1, start_batch=start_batch,
                        packed=packed)


def dispatch_batches(codes: np.ndarray, offsets: np.ndarray,
                     cfg: KmerConfig, dev: torch.device, step,
                     log: StatsLogger, span: int | None = None,
                     start_batch: int = 0):
    """Ship each device batch of a parsed chunk, from batch `start_batch`
    on, to `dev` and yield (the host batch, step(codes, lengths, limits,
    packed_width)).  Batches cross 2-bit packed; the ambiguity code
    needs a third bit, so skip-invalid mode ships u8 rows.  With the log
    enabled, each batch's line times its dispatch plus what the caller
    does with the yielded value."""
    packed = cfg.packed_transfer and not cfg.skip_invalid
    n = 0
    for batch in stagetime.stage_iter("batch_prep", device_batches(
            codes, offsets, cfg, packed, span, start_batch)):
        t0 = time.perf_counter() if log.enabled else 0.0
        with stagetime.stage("dispatch"):
            bc = batch.codes.view(np.int32) if packed else batch.codes
            with stagetime.stage("dispatch.h2d"):
                on_dev = (_to_device(bc, dev), _to_device(batch.lengths, dev),
                          _to_device(batch.start_limits, dev))
            with stagetime.stage("dispatch.step"):
                out = step(*on_dev, batch.packed_width)
        yield batch, out
        n += 1
        if log.enabled:
            log.log("batch", i=n, reads=int((batch.lengths > 0).sum()),
                    secs=round(time.perf_counter() - t0, 4))


def count_codes(codes: np.ndarray, offsets: np.ndarray, cfg: KmerConfig,
                stats: StatsLogger | None = None,
                device="cuda") -> KmerTable:
    """Count k-mers of pre-parsed records (the codes/offsets contract of
    io.fasta.parse_seqs) on `device` ("cuda" or "cpu").

    Sort mode: the device step is dispatched asynchronously and the
    host aggregation runs one batch behind: while the device counts
    batch i, the host merges batch i-1's pairs."""
    dev = resolve_device(device)
    log = stats or StatsLogger(enabled=cfg.stats)
    extra = {}
    if cfg.effective_mode == "dense":
        table, n_batches = _count_dense(codes, offsets, cfg, dev, log)
    elif (not cfg.compact and cfg.sort_group_keys > 0
          and _devmerge_ok(cfg, dev)):
        table, n_batches, extra["devmerge"] = _count_devmerge(
            codes, offsets, cfg, dev, log)
    else:
        table, n_batches = _count_sort(codes, offsets, cfg, dev, log)
    log.log("done", batches=n_batches, reads=len(offsets) - 1,
            distinct=table.num_distinct, total=table.total, **extra)
    return table


def sort_step(cfg: KmerConfig, dev: torch.device, compact: bool):
    """The sort-mode count step of `cfg` on `dev` and how the host reads
    a batch of it: (step, batch_pairs).  step(codes, lengths, limits,
    packed_width) launches the step on the batch's device tensors and
    starts its readback; batch_pairs(readback), after its wait(), gives
    the batch's unsorted (fused key, int64 count) pairs.  compact: the
    step packs its live lanes on the device (cfg.compact for count_codes;
    streaming's pass 1 ignores it, as kmer_tpu's does)."""
    k = cfg.n_bases
    bases = cfg.plane_bases
    win = dict(c_min=cfg.c_min, c_max=cfg.c_max, l_len=cfg.l_len,
               r_len=cfg.r_len, group_keys=cfg.sort_group_keys)
    copy_stream = (torch.cuda.Stream(dev) if compact and dev.type == "cuda"
                   else None)
    if cfg.gapped and compact:
        def step(codes_d, lengths_d, limits_d, pw):
            return _CompactReadback(gapped_step_compact(
                codes_d, lengths_d, limits_d, **win,
                mask_ambiguous=cfg.skip_invalid, packed_width=pw),
                copy_stream, bases)
    elif cfg.gapped:
        def step(codes_d, lengths_d, limits_d, pw):
            return _Readback(gapped_step_sort(
                codes_d, lengths_d, limits_d, **win,
                mask_ambiguous=cfg.skip_invalid, packed_width=pw))
    elif compact:
        def step(codes_d, lengths_d, limits_d, pw):
            return _CompactReadback(count_step_compact(
                codes_d, lengths_d, limits_d, k=k, canonical=cfg.canonical,
                mask_ambiguous=cfg.skip_invalid,
                group_keys=cfg.sort_group_keys, packed_width=pw),
                copy_stream, bases)
    else:
        def step(codes_d, lengths_d, limits_d, pw):
            keys, counts = count_step_sort(
                codes_d, lengths_d, limits_d, k=k, canonical=cfg.canonical,
                mask_ambiguous=cfg.skip_invalid,
                group_keys=cfg.sort_group_keys, packed_width=pw,
                positions=cfg.seed_positions)
            return _Readback((*key_planes(keys), counts))

    if compact:
        def batch_pairs(rb):
            return rb.pairs()                  # records as they came
    else:
        def batch_pairs(rb):
            *planes, counts = rb.host()
            return plane_run_pairs(planes, counts, bases)
    return step, batch_pairs


class HostMerge:
    """The sort-mode host aggregation of a stream of unsorted (fused key,
    int64 count) parts: buffered parts are bulk-merged (one sort over
    many batches, pipeline/table.reduce_fused) on a background thread
    once FLUSH_PAIRS pairs accumulate, while the caller goes on with the
    next batches; re-merging a growing table every batch would be
    O(total^2).  A merge that barely compacts backs the threshold off x4,
    which keeps the merge count logarithmic.  add() parts, then result()
    once; close() (in a finally) stops the thread."""

    FLUSH_PAIRS = 8 << 20

    def __init__(self):
        self.parts: list[tuple[np.ndarray, np.ndarray]] = []
        self.aggregated: set[int] = set()     # ids of sorted-unique parts
        self.buffered = 0
        self.flush_pairs = self.FLUSH_PAIRS
        self.pool = cf.ThreadPoolExecutor(max_workers=1)
        self.inflight: list[cf.Future] = []

    @staticmethod
    def _merge(snapshot):
        n_in = sum(len(c) for _, c in snapshot)
        merged = reduce_fused(np.concatenate([f for f, _ in snapshot]),
                              np.concatenate([c for _, c in snapshot]))
        return merged, n_in

    def _harvest(self) -> None:
        if self.inflight:
            with stagetime.stage("host_merge"):
                merged, n_in = self.inflight.pop().result()
            self.aggregated.add(id(merged))
            if len(merged[1]) > 0.75 * n_in:
                # barely compacted: later flushes would re-sort it, so
                # back off hard (x4 keeps the merge count logarithmic)
                self.flush_pairs *= 4
            self.parts.insert(0, merged)
            self.buffered += len(merged[1])

    def add(self, part: tuple[np.ndarray, np.ndarray]) -> None:
        self.parts.append(part)
        self.buffered += len(part[1])
        if self.buffered >= self.flush_pairs:
            self._harvest()
            if len(self.parts) > 1:
                self.inflight.append(self.pool.submit(self._merge,
                                                      self.parts))
                self.parts = []
                self.buffered = 0

    def result(self) -> tuple[np.ndarray, np.ndarray] | None:
        """The sorted unique (fused keys, counts) of every part, or None
        when no part came."""
        self._harvest()
        if len(self.parts) > 1 or (self.parts and id(self.parts[0])
                                   not in self.aggregated):
            with stagetime.stage("host_merge"):
                self.parts = [self._merge(self.parts)[0]]
        return self.parts[0] if self.parts else None

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def _count_sort(codes, offsets, cfg: KmerConfig, dev: torch.device,
                log: StatsLogger) -> tuple[KmerTable, int]:
    k = cfg.n_bases
    step, batch_pairs = sort_step(cfg, dev, cfg.compact)
    merge = HostMerge()

    def take(rb) -> None:
        with stagetime.stage("readback"):
            rb.wait()
        with stagetime.stage("table_build"):
            part = batch_pairs(rb)
        merge.add(part)

    pending = None
    n_batches = 0
    try:
        for _, rb in dispatch_batches(codes, offsets, cfg, dev, step, log):
            if pending is not None:
                take(pending)
            pending = rb
            n_batches += 1
        if pending is not None:
            take(pending)
        got = merge.result()
    finally:
        merge.close()
    if got is not None:
        fused, cts = got
        with stagetime.stage("convert"):
            words = unfuse_words(fused, k)
        return KmerTable(k, words, cts), n_batches
    return KmerTable.empty(k), n_batches


def devmerge_route(cfg: KmerConfig, dev: torch.device, sink=None):
    """The device-merge route of `cfg` on `dev`: (step, DeviceMerge).
    step(codes, lengths, limits, packed_width) returns the batch's (key
    planes, counts) on the device, for DeviceMerge.add; each drain hands
    a sorted unique (fused key, int64 count) part to `sink` (default:
    the DeviceMerge's parts)."""
    k = cfg.n_bases
    bases = cfg.plane_bases
    if cfg.gapped:
        win = dict(c_min=cfg.c_min, c_max=cfg.c_max, l_len=cfg.l_len,
                   r_len=cfg.r_len, group_keys=cfg.sort_group_keys)

        def step(codes_d, lengths_d, limits_d, pw):
            *planes, counts = gapped_step_sort(
                codes_d, lengths_d, limits_d, **win,
                mask_ambiguous=cfg.skip_invalid, packed_width=pw)
            return tuple(planes), counts
    else:
        def step(codes_d, lengths_d, limits_d, pw):
            keys, counts = count_step_sort(
                codes_d, lengths_d, limits_d, k=k, canonical=cfg.canonical,
                mask_ambiguous=cfg.skip_invalid,
                group_keys=cfg.sort_group_keys, packed_width=pw,
                positions=cfg.seed_positions)
            return key_planes(keys), counts

    def to_part(keys, counts):
        return plane_run_pairs([keys[:, q] for q in range(len(bases))],
                               counts, bases)
    # a pair's wire tiers read it as (l_len, r_len) bases
    wire = (dict(l_len=bases[0], r_len=bases[1]) if len(bases) == 2
            else {})
    dm = DeviceMerge(len(bases), dev, to_part, bits=bases_bits(bases),
                     sink=sink, **wire)
    return step, dm


def _count_devmerge(codes, offsets, cfg: KmerConfig, dev: torch.device,
                    log: StatsLogger) -> tuple[KmerTable, int, dict]:
    """Sort mode with the table on the device (DeviceMerge): no
    per-batch readback; the distinct rows cross once a drain.  Also
    returns the DeviceMerge's tally."""
    k = cfg.n_bases
    step, dm = devmerge_route(cfg, dev)
    n_batches = 0
    for _, (words, counts) in dispatch_batches(codes, offsets, cfg, dev,
                                               step, log):
        dm.add(words, counts)
        n_batches += 1
    parts = dm.finish()
    if not parts:
        return KmerTable.empty(k), n_batches, dm.tally
    if len(parts) == 1:
        fused, cts = parts[0]
    else:
        with stagetime.stage("host_merge"):
            fused, cts = reduce_fused(np.concatenate([f for f, _ in parts]),
                                      np.concatenate([c for _, c in parts]))
    with stagetime.stage("convert"):
        words = unfuse_words(fused, k)
    return KmerTable(k, words, cts), n_batches, dm.tally


def _count_dense(codes, offsets, cfg: KmerConfig, dev: torch.device,
                 log: StatsLogger) -> tuple[KmerTable, int]:
    """Dense mode: k <= 8 accumulates a device-resident int64 4**k table
    (kernel K5) read once at the end; k = 9..12 runs the sort-mode step
    and adds each batch's live pairs into a host 4**k table one batch
    behind the device, or, under dense_scatter_ok, into a device table
    read once."""
    k = cfg.k
    n_batches = 0
    if k <= DENSE_DEVICE_K_MAX or dense_scatter_ok(dev):
        hist = torch.zeros(4 ** k, dtype=torch.int64, device=dev)
        dense_step = (count_step_dense if k <= DENSE_DEVICE_K_MAX
                      else count_step_scatter)

        def step(codes_d, lengths_d, limits_d, pw):
            return dense_step(codes_d, lengths_d, limits_d, hist, k=k,
                              canonical=cfg.canonical,
                              mask_ambiguous=cfg.skip_invalid,
                              packed_width=pw)
        for _ in dispatch_batches(codes, offsets, cfg, dev, step, log):
            n_batches += 1
        with stagetime.stage("readback"):
            final = hist.cpu().numpy()
        return KmerTable.from_dense(final, k), n_batches

    table = np.zeros(4 ** k, np.int64)

    def step(codes_d, lengths_d, limits_d, pw):
        return _Readback(fused_step(
            codes_d, lengths_d, limits_d, k=k, canonical=cfg.canonical,
            mask_ambiguous=cfg.skip_invalid, packed_width=pw))

    def take(rb: _Readback) -> None:
        with stagetime.stage("readback"):
            rb.wait()
            keys, counts = device_run_pairs(*rb.host())
        with stagetime.stage("host_merge"):
            np.add.at(table, keys.view(np.int64), counts)

    pending = None
    for _, rb in dispatch_batches(codes, offsets, cfg, dev, step, log):
        if pending is not None:
            take(pending)
        pending = rb
        n_batches += 1
    if pending is not None:
        take(pending)
    return KmerTable.from_dense(table, k), n_batches


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
    for codes, offsets in iter_chunks(paths, cfg):
        acc.add(count_codes(codes, offsets, cfg, device=device))
    with stagetime.stage("host_merge"):
        return acc.result()


def iter_chunks(paths, cfg: KmerConfig, start_cursor: int = 0,
                cursors: bool = False):
    """(codes, offsets) of each parsed ingest chunk of each file: chunked
    by cfg.ingest_chunk_bases and parsed on a background thread, or each
    whole file when that is 0.  cursors: yield (codes, offsets, cursor),
    the cursor the uncompressed byte offset after the chunk (-1 after a
    whole-file parse).  start_cursor: where the first file's parse
    starts, a cursor an earlier parse of it yielded."""
    for p in paths:
        if cfg.ingest_chunk_bases > 0:
            chunks = stagetime.stage_iter("ingest", prefetch_iter(
                iter_parse_chunks(p, max_bases=cfg.ingest_chunk_bases,
                                  allow_ambiguous=cfg.skip_invalid,
                                  start_cursor=start_cursor,
                                  min_qual=cfg.min_qual)))
        elif start_cursor:
            raise ValueError("a resume cursor needs chunked ingest "
                             "(ingest_chunk_bases > 0)")
        else:
            with stagetime.stage("ingest"):
                codes, offsets = parse_seqs(p,
                                            allow_ambiguous=cfg.skip_invalid,
                                            min_qual=cfg.min_qual)
            chunks = [(codes, offsets, -1)]
        start_cursor = 0
        for codes, offsets, cursor in chunks:
            yield (codes, offsets, cursor) if cursors else (codes, offsets)
