"""Multi-GPU count steps: routed (key, count) pairs, the sorted stream,
and dense tables.

Counterpart of kmer_tpu/parallel/distributed.py.  A batch is cut over
the mesh (mesh.split_batch): rows over the data axis, and optionally
columns over the seq axis with a halo (halo.py).  Each step is written
once, as phases over this process's positions: a local phase (each
position's kernels), a collective (comm), a local phase.

Routing: a key's owner is route_dest, the top tb = min(16, 2 n_bases)
bits of its value scaled to the mesh, which is monotone in the key, so
the owners' tables concatenated in position order are the sorted global
table; equal keys share an owner, and integer counts make every table
bit-identical for every mesh shape and world size.  Dead lanes (the
sentinel key, or count 0) are routed nowhere.

- The pairs steps (make_distributed_count_pairs, K1 on each position;
  make_distributed_gapped_pairs, K3) count locally with the fused step's
  in-segment collapse -- or, for keys K1 and K3 do not take (over 63
  bases, gapped windows over 31), with the single-device unfused step
  (K7 and the grouped dedup) -- partition the (key, count) pairs by
  owner with one stable digit pass of K6 (key planes and counts as
  payload), and exchange them; the host aggregates each owner's pairs
  (pipeline/table.KmerTable.from_routed_pairs).
- The sorted-stream steps (make_distributed_count, K7; and
  make_distributed_gapped, K3 or K7's gapped lanes with their counts as
  payload) sort each position's key planes with K6, exchange, sort again
  and take run lengths: each owner's stream is sorted, and their
  concatenation is globally sorted.  KMER_TPU_MULTIHOST_STEP=legacy
  selects them.

A key travels as the int64 planes of ops/encode (KmerConfig.plane_bases),
W of them at any width, and the exchange carries W + 1 planes a row.
- make_distributed_dense: K1 + K5 (k <= 8) or K1 + index_add_ (k =
  9..12) into an int64 4**k table on each position, then an all-reduce or
  a reduce-scatter.

kmer_tpu ships routed keys in static (n_dev, capacity) buffers with an
overflow flag and a capacity-doubling retry; here rows travel at their
exact sizes (comm.all_to_all), so there is no capacity, no flag and no
retry, whatever the skew.
"""

from __future__ import annotations

import functools
import os

import torch

from ..ops import count as count_ops
from ..ops.encode import (LO_FLIP, PAIR_BASES, SENTINEL_KEY, bases_bits,
                          gapped_bases, key_planes, word_bases)
from ..ops.extract import check_window, parse_seed_mask
from ..ops.kernels.extract import extract_keys
from ..pipeline.count import (DENSE_DEVICE_K_MAX, count_step_dense,
                              count_step_scatter, count_step_sort,
                              fused_step, gapped_step_sort)
from ..utils import stagetime
from . import comm
from .halo import halo_extend, seq_shard_bounds
from .mesh import Mesh, ShardedBatch

# top-of-key bits used for routing (order-preserving for any mesh size)
ROUTE_BITS = 16


def route_dest(planes, bases, n_dev: int):
    """Owner of each key, top * n_dev >> tb, top the key value's top tb =
    min(ROUTE_BITS, 2 n_bases) bits: monotone in the key, so routing keeps
    the global order for any n_dev.  planes: the key's int64 planes (torch
    tensors, or numpy arrays of int64), most significant first; bases:
    each plane's bases (ops/encode: KmerConfig.plane_bases; a 32-base
    plane's top bit is flipped; plane 0 may hold 0 bases).  The top bits
    lie in plane 0, or straddle planes 0 and 1.  Dead lanes get an owner
    too; callers mark them."""
    tb = min(ROUTE_BITS, 2 * sum(bases))
    bits0 = 2 * bases[0]
    if bits0 >= tb:
        top = planes[0] >> (bits0 - tb)
    else:
        need = tb - bits0
        lo = planes[1] ^ LO_FLIP if bases[1] == 32 else planes[1]
        top = (planes[0] << need) | ((lo >> (2 * bases[1] - need))
                                     & ((1 << need) - 1))
    return (top * n_dev) >> tb


def pairs_eligible(cfg) -> bool:
    """The policy of count_fasta_multihost and StreamingCounter(mesh=):
    the pairs step, unless KMER_TPU_MULTIHOST_STEP=legacy asks for the
    sorted stream.  K1 and K3 take every key the port accepts, so
    nothing else decides."""
    return os.environ.get("KMER_TPU_MULTIHOST_STEP", "pairs") != "legacy"


def _check_use_seq(mesh: Mesh, use_seq: bool | None) -> None:
    if use_seq is False and mesh.n_seq > 1:
        # replicating shards over an unused seq axis would multiply every
        # count by n_seq
        raise ValueError(f"use_seq=False on a mesh with seq={mesh.n_seq}; "
                         "build the mesh with n_seq=1 instead")


def _shards(mesh: Mesh, batch: ShardedBatch, span: int):
    """Each local position's (codes, lengths, limits, packed_width) for a
    kernel of window span `span`: on a seq mesh the shard grows by its
    halo (whole words when packed) and its lengths and limits shift to
    it, so the kernel sees windows p < shard only, p + span <= width."""
    pw = batch.width if batch.packed else 0
    if mesh.n_seq == 1:
        return list(zip(batch.codes, batch.lengths, batch.limits,
                        [pw] * mesh.n_local))
    halo = -(-(span - 1) // 16) if batch.packed else span - 1
    width = batch.width + span - 1
    out = []
    for i, codes in enumerate(halo_extend(mesh, batch.codes, halo)):
        lengths, limits = seq_shard_bounds(
            batch.lengths[i], batch.limits[i], i % mesh.n_seq, batch.width,
            width)
        out.append((codes, lengths, limits, width if batch.packed else 0))
    return out


def _owner_sizes(dest: torch.Tensor, n_dev: int) -> torch.Tensor:
    """(n_dev,) lanes a non-decreasing owner stream holds for each owner
    (the dead owner n_dev last)."""
    bounds = torch.searchsorted(
        dest, torch.arange(n_dev + 1, dtype=torch.int64, device=dest.device))
    return bounds[1:] - bounds[:-1]


def _route_pairs(planes, counts, bases, n_dev: int):
    """One position's (key, count) lanes, the key planes of the layout
    `bases`, partitioned by owner: a stable sort on the owner id alone
    (K6, one digit; keys and counts as payload, dead lanes last).
    Returns (the W + 1 planes, lanes per owner)."""
    planes = [p.reshape(-1) for p in planes]
    counts = counts.reshape(-1).to(torch.int64)
    dest = route_dest(planes, bases, n_dev)
    dest = torch.where((planes[0] == SENTINEL_KEY) | (counts == 0), n_dev,
                       dest)
    s = count_ops.sort_words([dest, *planes, counts], num_keys=1,
                             bits=(n_dev.bit_length(),))
    return s[1:], _owner_sizes(s[0], n_dev)


def _pairs_step(mesh: Mesh, batch: ShardedBatch, span: int, local):
    """The pairs steps' phases: local(codes, lengths, limits, pw) -> (the
    owner-partitioned planes, lanes per owner) on each position, the
    exchange, and the routed planes as (key planes, counts) an owner."""
    with stagetime.stage("dispatch"):
        sends, sizes = zip(*[local(*shard)
                             for shard in _shards(mesh, batch, span)])
    return [(tuple(r[:-1]), r[-1])
            for r in comm.all_to_all(mesh, list(sends), list(sizes))]


def make_distributed_count_pairs(mesh: Mesh, *, k: int,
                                 canonical: bool = False,
                                 use_seq: bool | None = None,
                                 mask_ambiguous: bool = False,
                                 seed_mask: str | None = None,
                                 group_keys: int = 256):
    """The fused-local distributed count over `mesh`.  Returns
    fn(batch: ShardedBatch) -> [(key planes, counts int64) for each of
    this process's owners]: the routed pairs, keys as the port's int64
    planes (ops/encode.word_bases: one, (hi, lo) for 32 to 63 bases, W
    beyond), equal keys possibly repeated; aggregate with
    KmerTable.from_routed_pairs.  Each position runs K1 (spaced seeds and
    two-word keys included) or, past 63 bases, the single-device unfused
    step (K7, then the grouped dedup at m = group_keys, or K6's flat sort
    at 0; pipeline/count.count_step_sort), then the owner partition
    (K6)."""
    _check_use_seq(mesh, use_seq)
    positions = None
    if seed_mask is not None:
        positions = parse_seed_mask(seed_mask)
        k = len(positions)                # key width = popcount
    span = check_window(k, positions, canonical)
    bases = word_bases(k)
    step = fused_step if k <= PAIR_BASES else functools.partial(
        count_step_sort, group_keys=group_keys)

    def local(codes, lengths, limits, pw):
        keys, counts = step(codes, lengths, limits, k=k, canonical=canonical,
                            mask_ambiguous=mask_ambiguous, packed_width=pw,
                            positions=positions)
        return _route_pairs(key_planes(keys), counts, bases, mesh.n_dev)

    def fn(batch: ShardedBatch):
        return _pairs_step(mesh, batch, span, local)
    return fn


def make_distributed_gapped_pairs(mesh: Mesh, *, l_len: int = 27,
                                  r_len: int = 27, c_min: int = 80,
                                  c_max: int = 140,
                                  use_seq: bool | None = None,
                                  mask_ambiguous: bool = False,
                                  group_keys: int = 256):
    """The fused-local distributed gapped count: the single-device gapped
    step on each position (K3, the chunk keys of every c and the
    in-segment collapse, for windows of at most 31 bases; else K7's
    gapped lanes and the grouped dedup: pipeline/count.gapped_step_sort),
    then the owner partition (K6).  fn(batch) -> [(key planes, counts) an
    owner], the planes those of ops/encode.gapped_bases.  A K3 shard with
    its halo, L / n_seq + c_max - 1 bases, must fit
    fused_gapped.MAX_ROW."""
    _check_use_seq(mesh, use_seq)
    win = dict(l_len=l_len, r_len=r_len, c_min=c_min, c_max=c_max,
               mask_ambiguous=mask_ambiguous, group_keys=group_keys)
    bases = gapped_bases(l_len, r_len)

    def local(codes, lengths, limits, pw):
        *planes, counts = gapped_step_sort(codes, lengths, limits,
                                           packed_width=pw, **win)
        return _route_pairs(planes, counts, bases, mesh.n_dev)

    def fn(batch: ShardedBatch):
        return _pairs_step(mesh, batch, c_max, local)
    return fn


def _run_sums(words, weights: torch.Tensor | None) -> torch.Tensor:
    """int64 counts of a sorted stream: at each run's first lane its
    length (weights None) or the sum of its weights, 0 elsewhere and on
    the sentinel run."""
    counts = count_ops.run_lengths(words).to(torch.int64)
    if weights is None:
        return counts
    idx = torch.nonzero(counts > 0).reshape(-1)
    csum = torch.cumsum(weights, 0)
    ends = idx + counts[idx] - 1
    out = torch.zeros_like(counts)
    out[idx] = csum[ends] - csum[idx] + weights[idx]
    return out


def _sorted_stream(mesh: Mesh, batch: ShardedBatch, span: int, local,
                   bases):
    """The sorted-stream step's phases: local(codes, lengths, limits, pw)
    -> (key planes, weights or None) on each position; K6 sorts them, the
    sorted stream routes by owner (monotone, so dead lanes trail), the
    exchange, K6 again and the run counts.  bases: the key planes'
    layout."""
    W, bits = len(bases), bases_bits(bases)
    sends, sizes = [], []
    with stagetime.stage("dispatch"):
        for codes, lengths, limits, pw in _shards(mesh, batch, span):
            planes, weights = local(codes, lengths, limits, pw)
            words = [p.reshape(-1) for p in planes]
            if weights is not None:
                words.append(weights.reshape(-1).to(torch.int64))
            s = count_ops.sort_words(words, num_keys=W, bits=bits)
            dest = route_dest(s[:W], bases, mesh.n_dev)
            dest = torch.where(s[0] == SENTINEL_KEY, mesh.n_dev, dest)
            sends.append(s)
            sizes.append(_owner_sizes(dest, mesh.n_dev))
    recv = comm.all_to_all(mesh, sends, sizes)
    out = []
    with stagetime.stage("dispatch"):
        for r in recv:
            s2 = count_ops.sort_words(r, num_keys=W, bits=bits)
            out.append((tuple(s2[:W]),
                        _run_sums(s2[:W], s2[W] if len(s2) > W else None)))
    return out


def make_distributed_count(mesh: Mesh, *, k: int, canonical: bool = False,
                           use_seq: bool | None = None,
                           mask_ambiguous: bool = False):
    """The sorted-stream distributed count over `mesh`: K7 on each
    position, K6, the exchange, K6 and run lengths.  fn(batch) -> [(sorted
    key planes, counts int64) an owner], each count on its run's first
    lane (0 elsewhere); the owners' streams concatenated in position order
    are the globally sorted stream (KmerTable.from_routed_pairs takes
    them)."""
    _check_use_seq(mesh, use_seq)
    check_window(k)

    def local(codes, lengths, limits, pw):
        return key_planes(extract_keys(codes, lengths, limits, k,
                                       canonical=canonical,
                                       mask_ambiguous=mask_ambiguous,
                                       packed_width=pw)), None

    def fn(batch: ShardedBatch):
        return _sorted_stream(mesh, batch, k, local, word_bases(k))
    return fn


def make_distributed_gapped(mesh: Mesh, *, l_len: int = 27, r_len: int = 27,
                            c_min: int = 80, c_max: int = 140,
                            use_seq: bool | None = None,
                            mask_ambiguous: bool = False):
    """The sorted-stream distributed gapped count: the single-device
    gapped step on each position (K3, or K7's gapped lanes and the grouped
    dedup past 31 bases), its planes sorted with their counts as payload
    (K6), the exchange, K6 and the runs' count sums.  Same contract as
    make_distributed_count."""
    _check_use_seq(mesh, use_seq)
    win = dict(l_len=l_len, r_len=r_len, c_min=c_min, c_max=c_max,
               mask_ambiguous=mask_ambiguous)

    def local(codes, lengths, limits, pw):
        *planes, counts = gapped_step_sort(codes, lengths, limits,
                                           packed_width=pw, **win)
        return planes, counts

    def fn(batch: ShardedBatch):
        return _sorted_stream(mesh, batch, c_max, local,
                              gapped_bases(l_len, r_len))
    return fn


def make_step(mesh: Mesh, cfg):
    """The sort-mode step of `cfg` over `mesh`, the one
    count_fasta_multihost and StreamingCounter(mesh=) run: the pairs step
    unless pairs_eligible says legacy, at every key width; its routed
    planes are those of cfg.plane_bases."""
    use_pairs = pairs_eligible(cfg)
    if cfg.seed_mask is not None and not use_pairs:
        raise ValueError("spaced seeds need the pairs step; unset "
                         "KMER_TPU_MULTIHOST_STEP=legacy")
    mask = cfg.skip_invalid
    if cfg.gapped:
        if use_pairs:
            return make_distributed_gapped_pairs(
                mesh, l_len=cfg.l_len, r_len=cfg.r_len, c_min=cfg.c_min,
                c_max=cfg.c_max, mask_ambiguous=mask,
                group_keys=cfg.sort_group_keys)
        return make_distributed_gapped(mesh, l_len=cfg.l_len,
                                       r_len=cfg.r_len, c_min=cfg.c_min,
                                       c_max=cfg.c_max, mask_ambiguous=mask)
    if use_pairs:
        return make_distributed_count_pairs(mesh, k=cfg.k,
                                            canonical=cfg.canonical,
                                            mask_ambiguous=mask,
                                            seed_mask=cfg.seed_mask,
                                            group_keys=cfg.sort_group_keys)
    return make_distributed_count(mesh, k=cfg.k, canonical=cfg.canonical,
                                  mask_ambiguous=mask)


def gather_owners(routed) -> list[torch.Tensor]:
    """A step's output for this process's owners as one set of planes,
    key planes then counts, the owners in position order (on the first
    owner's device): their keys are disjoint ranges in key order."""
    dev = routed[0][1].device
    cols = list(zip(*[(*words, counts) for words, counts in routed]))
    return [torch.cat([c.to(dev) for c in col]) for col in cols]


class DistributedDense:
    """Dense 4**k counting over a mesh of data rows only (n_seq = 1).
    add(batch) counts a batch into each position's int64 table: K1 + K5
    for k <= 8, K1 + index_add_ for k = 9..12 (the single-device dense
    choice); reduce() sums the tables over the mesh and starts afresh:
    the whole table (scatter=False, an all-reduce) or this process's
    positions' equal shards of it (scatter=True, a reduce-scatter).
    Counts stay int64 throughout, so no table needs draining; calling the
    object is add then reduce (kmer_tpu's per-batch step)."""

    def __init__(self, mesh: Mesh, k: int, canonical: bool = False,
                 scatter: bool = False, mask_ambiguous: bool = False):
        if mesh.n_seq > 1:
            raise ValueError(f"dense mode splits rows only; build the mesh "
                             f"with n_seq=1 (got seq={mesh.n_seq})")
        if not 1 <= k <= 12:
            raise ValueError("dense mode requires k <= 12")
        self.mesh, self.k, self.scatter = mesh, k, scatter
        self.kw = dict(k=k, canonical=canonical,
                       mask_ambiguous=mask_ambiguous)
        self.step = (count_step_dense if k <= DENSE_DEVICE_K_MAX
                     else count_step_scatter)
        self.tables = None

    def _zeros(self) -> list[torch.Tensor]:
        return [torch.zeros(4 ** self.k, dtype=torch.int64, device=d)
                for d in self.mesh.devices]

    def add(self, batch: ShardedBatch) -> None:
        if self.tables is None:
            self.tables = self._zeros()
        with stagetime.stage("dispatch"):
            for (codes, lengths, limits, pw), t in zip(
                    _shards(self.mesh, batch, self.k), self.tables):
                self.step(codes, lengths, limits, t, packed_width=pw,
                          **self.kw)

    def reduce(self):
        tables, self.tables = self.tables or self._zeros(), None
        if self.scatter:
            return comm.reduce_scatter(self.mesh, tables)
        return comm.all_reduce(self.mesh, tables)

    def __call__(self, batch: ShardedBatch):
        self.add(batch)
        return self.reduce()


def make_distributed_dense(mesh: Mesh, *, k: int, canonical: bool = False,
                           scatter: bool = False,
                           mask_ambiguous: bool = False) -> DistributedDense:
    """Dense 4**k counting over `mesh` (DistributedDense)."""
    return DistributedDense(mesh, k, canonical, scatter, mask_ambiguous)
