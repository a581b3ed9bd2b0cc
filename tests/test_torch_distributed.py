"""The port's multi-GPU count steps (kmer_tpu_torch.parallel) against
kmer_tpu's distributed steps on the CPU, bit for bit.

The port's in-process mesh of 8 CPU positions runs the same numpy-seeded
batches as kmer_tpu's shard_map steps on the conftest's 8 virtual
devices:

- the pairs step (K1's plain version on each position) and the sorted
  stream (K7, K6) at (8, 1), (4, 2) and (1, 8), k = 15, 16, 21, 31, 32,
  45 and 63, canonical and not, skip-invalid rows with ambiguous bases,
  spaced masks, the gapped pairs step (K3) and the gapped sorted stream,
  and dense tables by all-reduce and by reduce-scatter: each final table
  equals kmer_tpu's, and so does each owner's partial table (the same
  owner ranges, so the routing is kmer_tpu's);
- route_dest equals kmer_tpu's _route_dest and streaming's route_fused
  for W = 1..4 and for gapped keys;
- the halo: multi-hop on narrow packed and u8 shards, and the shifted
  lengths and limits of a seq shard select exactly the windows that
  start inside it;
- the tables are identical across mesh shapes; the legacy streams'
  concatenation is globally sorted; use_seq=False on a seq mesh and
  widths that do not split are refused.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.parallel import distributed as jd
from kmer_tpu.parallel import mesh as jmesh
from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops.encode import (key_planes, key_words_from_codes,
                                       u32_to_pairs, word_bases)
from kmer_tpu_torch.ops.extract import window_keys
from kmer_tpu_torch.parallel import distributed as td
from kmer_tpu_torch.parallel import halo
from kmer_tpu_torch.parallel.mesh import make_mesh, split_batch
from kmer_tpu_torch.pipeline import streaming
from kmer_tpu_torch.pipeline.table import KmerTable, fuse_words

SHAPES = [(8, 1), (4, 2), (1, 8)]
B, L = 16, 128            # (1, 8): 16-base shards, one packed word each
GAP = dict(l_len=5, r_len=5, c_min=12, c_max=40)   # a 39-base halo: 3 hops


def _batch(seed: int, amb: bool = False):
    """B rows of L codes (1% of them code 4 when amb), random lengths and
    limits, a few rows empty or short."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.01] = 4
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[:2] = (0, 7)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    limits[2:6] = L
    return codes, lengths, limits


@functools.lru_cache(maxsize=None)
def _jax_out(maker: str, seed: int, amb: bool, **kw):
    """kmer_tpu's step on the (8, 1) virtual mesh: (its table, each
    device's partial table).  Its owners depend on the device count
    alone, so these are every 8-position shape's."""
    codes, lengths, limits = _batch(seed, amb)
    fn = getattr(jd, maker)(jmesh.make_mesh(8, 1), **kw)
    out = fn(jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(limits))
    n_bases = kw.get("k") or kw["l_len"] + kw["r_len"]
    if kw.get("seed_mask"):
        n_bases = kw["seed_mask"].count("1")

    def shards(arr):
        got = sorted(arr.addressable_shards,
                     key=lambda s: s.index[0].start or 0)
        return [np.asarray(s.data) for s in got]
    if maker.endswith("pairs"):
        words, counts, overflow = out
        assert not bool(overflow)
        ws = [shards(w) for w in words]
        parts = [JaxTable.from_routed_pairs(n_bases, [w[j] for w in ws], c)
                 for j, c in enumerate(shards(counts))]
    else:
        s, is_start, counts, overflow = out
        assert not bool(overflow)
        ss = [shards(w) for w in s]
        parts = [JaxTable.from_device_runs(n_bases, [w[j] for w in ss], st, c)
                 for j, (st, c) in enumerate(zip(shards(is_start),
                                                 shards(counts)))]
    table = JaxTable.from_pairs(
        n_bases, np.concatenate([p.keys for p in parts]),
        np.concatenate([p.counts for p in parts]))
    return table, parts


def _port_out(fn, shape, seed: int, amb: bool, n_bases: int, bases=None):
    """The port's step on an in-process CPU mesh: (table, owner tables,
    the routed output)."""
    codes, lengths, limits = _batch(seed, amb)
    mesh = make_mesh(*shape, devices=["cpu"] * 8)
    if amb:
        batch = split_batch(mesh, codes, lengths, limits)
    else:
        batch = split_batch(mesh, pack_batch_codes(codes).view(np.int32),
                            lengths, limits, packed_width=L)
    routed = fn(mesh)(batch)
    parts = [KmerTable.from_routed_pairs(n_bases, w, c, bases)
             for w, c in routed]
    table = KmerTable.from_pairs(
        n_bases, np.concatenate([p.keys for p in parts]),
        np.concatenate([p.counts for p in parts]))
    return table, parts, routed


def _same(port, jax_ref):
    table, parts, _ = port
    want, want_parts = jax_ref
    assert table.num_distinct > 0
    assert table == want
    assert len(parts) == len(want_parts)
    for got, exp in zip(parts, want_parts):
        assert got == exp


KS = [15, 16, 21, 31, 32, 45, 63]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_pairs_step_equals_kmer_tpu(shape, k, canonical):
    port = _port_out(lambda m: td.make_distributed_count_pairs(
        m, k=k, canonical=canonical), shape, k, False, k)
    _same(port, _jax_out("make_distributed_count_pairs", k, False, k=k,
                         canonical=canonical))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k,canonical", [(16, False), (21, True),
                                         (32, True), (63, False)])
def test_sorted_stream_equals_kmer_tpu(shape, k, canonical):
    port = _port_out(lambda m: td.make_distributed_count(
        m, k=k, canonical=canonical), shape, k, False, k)
    _same(port, _jax_out("make_distributed_count", k, False, k=k,
                         canonical=canonical))
    # each owner's stream is sorted, and so is their concatenation
    keys = np.concatenate([p.keys for p in port[1]])
    void = [bytes(r) for r in keys.astype(">u4")]
    assert void == sorted(set(void))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [21, 45])
def test_skip_invalid_pairs_equal_kmer_tpu(shape, k):
    port = _port_out(lambda m: td.make_distributed_count_pairs(
        m, k=k, canonical=True, mask_ambiguous=True), shape, k + 1, True, k)
    _same(port, _jax_out("make_distributed_count_pairs", k + 1, True, k=k,
                         canonical=True, mask_ambiguous=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask,canonical", [
    ("110101011", True),
    ("1" * 20 + "0" * 10 + "1" * 20, False)])      # 40 bases: a pair
def test_spaced_pairs_equal_kmer_tpu(shape, mask, canonical):
    n = mask.count("1")
    port = _port_out(lambda m: td.make_distributed_count_pairs(
        m, k=21, canonical=canonical, seed_mask=mask), shape, n, False, n)
    _same(port, _jax_out("make_distributed_count_pairs", n, False, k=21,
                         canonical=canonical, seed_mask=mask))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("legacy", [False, True])
def test_gapped_steps_equal_kmer_tpu(shape, legacy):
    name = "make_distributed_gapped" + ("" if legacy else "_pairs")
    n = GAP["l_len"] + GAP["r_len"]
    port = _port_out(lambda m: getattr(td, name)(m, **GAP), shape, 3,
                     False, n, (GAP["l_len"], GAP["r_len"]))
    _same(port, _jax_out(name, 3, False, **GAP))


@pytest.mark.parametrize("k", [6, 9])
@pytest.mark.parametrize("scatter", [False, True])
def test_dense_equals_kmer_tpu(k, scatter):
    codes, lengths, limits = _batch(5)
    jfn = jd.make_distributed_dense(jmesh.make_mesh(8, 1), k=k,
                                    canonical=True, scatter=scatter)
    want = np.asarray(jfn(jnp.asarray(codes), jnp.asarray(lengths),
                          jnp.asarray(limits)))
    mesh = make_mesh(8, 1, devices=["cpu"] * 8)
    fn = td.make_distributed_dense(mesh, k=k, canonical=True,
                                   scatter=scatter)
    batch = split_batch(mesh, pack_batch_codes(codes).view(np.int32),
                        lengths, limits, packed_width=L)
    got = fn(batch)
    if scatter:
        assert len(got) == 8 and all(g.numel() == 4 ** k // 8 for g in got)
        got = torch.cat(got)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.sum()) > 0


def test_tables_identical_across_mesh_shapes():
    codes, lengths, limits = _batch(11)
    packed = pack_batch_codes(codes).view(np.int32)
    tables = []
    for shape in [(1, 1), (2, 1), (4, 1), (8, 1), (2, 4), (1, 8), (4, 2)]:
        mesh = make_mesh(*shape, devices=["cpu"] * 8)
        routed = td.make_distributed_count_pairs(mesh, k=21)(
            split_batch(mesh, packed, lengths, limits, packed_width=L))
        w, c = td.gather_owners(routed)
        tables.append(KmerTable.from_routed_pairs(21, [w], c))
    assert tables[0].num_distinct > 0
    assert all(t == tables[0] for t in tables[1:])


# --------------------------------------------------------------- routing

def _random_keys(rng, n_bases: int, n: int = 500):
    codes = rng.integers(0, 4, (n, n_bases))
    codes[:20] = 0                            # the smallest and
    codes[20:40] = 3                          # the largest keys
    return key_words_from_codes(codes, n_bases)


@pytest.mark.parametrize("n_dev", [1, 3, 8, 16])
@pytest.mark.parametrize("n_bases", [5, 8, 15, 16, 21, 31, 32, 33, 40, 45,
                                     48, 63])
def test_route_dest_equals_kmer_tpu_and_route_fused(n_bases, n_dev):
    words = _random_keys(np.random.default_rng(n_bases + n_dev), n_bases)
    W = words.shape[1]
    want = np.asarray(jd._route_dest(
        jnp.asarray(words[:, 0]), jnp.asarray(words[:, 1]) if W > 1 else None,
        n_bases, n_dev))
    bases = word_bases(n_bases)
    if n_bases <= 31:
        planes = (torch.from_numpy(fuse_words(words, n_bases)
                                   .view(np.int64)),)
    else:
        planes = tuple(torch.from_numpy(p)
                       for p in u32_to_pairs(words, 31, n_bases - 31))
    got = td.route_dest(planes, bases, n_dev).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        streaming.route_fused(fuse_words(words, n_bases), n_bases, n_dev),
        want)
    assert got.min() >= 0 and got.max() < n_dev


@pytest.mark.parametrize("l_len,r_len", [(4, 4), (5, 12), (27, 27),
                                         (31, 31), (2, 30)])
def test_route_dest_gapped_keys(l_len, r_len):
    n = l_len + r_len
    words = _random_keys(np.random.default_rng(n), n)
    hi, lo = u32_to_pairs(words, l_len, r_len)
    W = words.shape[1]
    for n_dev in (2, 5, 8):
        want = np.asarray(jd._route_dest(
            jnp.asarray(words[:, 0]),
            jnp.asarray(words[:, 1]) if W > 1 else None, n, n_dev))
        got = td.route_dest((torch.from_numpy(hi), torch.from_numpy(lo)),
                            (l_len, r_len), n_dev)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ halo

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("halo_cols", [1, 3, 5])
def test_halo_extend_multi_hop(packed, halo_cols):
    """A halo of 1, 3 and 5 shard-widths' worth on 4 seq shards: each
    shard's next columns come from 1, 2, ... shards to its right around
    the ring."""
    rng = np.random.default_rng(halo_cols)
    n_seq, shard = 4, 2                 # columns a shard (words or bases)
    cols = rng.integers(0, 2 ** 31 if packed else 4,
                        (3, n_seq * shard)).astype(np.int32 if packed
                                                   else np.uint8)
    mesh = make_mesh(2, n_seq, devices=["cpu"] * 8)
    blocks = [torch.from_numpy(cols[:, s * shard:(s + 1) * shard].copy())
              for _ in range(2) for s in range(n_seq)]
    need = halo_cols * shard - 1
    out = halo.halo_extend(mesh, blocks, need)
    ring = np.concatenate([cols] * (halo_cols + 2), axis=1)
    for i, o in enumerate(out):
        s = i % n_seq
        np.testing.assert_array_equal(
            o.numpy(), ring[:, s * shard:s * shard + shard + need])
    assert mesh.stats["halo_bytes"] == 8 * 3 * need * cols.itemsize


@pytest.mark.parametrize("span", [1, 5, 21, 40])
def test_seq_shard_bounds_select_the_shards_windows(span):
    """Windows of the halo-extended shard under seq_shard_bounds are
    exactly the global windows that start inside the shard, within its
    read and limit (seq_shard_lane_mask & limit), read from the right
    bases."""
    codes, lengths, limits = _batch(span)
    n_seq = 4
    shard = L // n_seq
    mesh = make_mesh(1, n_seq, devices=["cpu"] * 4)
    blocks = [torch.from_numpy(codes[:, s * shard:(s + 1) * shard].copy())
              for s in range(n_seq)]
    ext = halo.halo_extend(mesh, blocks, span - 1)
    gkeys, gvalid = window_keys(torch.from_numpy(codes),
                                torch.from_numpy(lengths), range(span),
                                limits=torch.from_numpy(limits))
    for s, e in enumerate(ext):
        ln, lm = halo.seq_shard_bounds(torch.from_numpy(lengths),
                                       torch.from_numpy(limits), s, shard,
                                       shard + span - 1)
        keys, valid = window_keys(e, ln, range(span), limits=lm)
        want = halo.seq_shard_lane_mask(torch.from_numpy(lengths), s, shard,
                                        span)
        gpos = torch.arange(shard)[None, :] + s * shard
        want &= gpos < torch.from_numpy(limits)[:, None]
        assert torch.equal(valid, want)
        n = max(min(shard, L - span + 1 - s * shard), 0)
        cut = slice(s * shard, s * shard + n)
        assert torch.equal(valid[:, :n], gvalid[:, cut])
        for w, g in zip(key_planes(keys), key_planes(gkeys)):
            assert torch.equal(torch.where(valid[:, :n], w[:, :n], -1),
                               torch.where(gvalid[:, cut], g[:, cut], -1))


# ---------------------------------------------------------------- checks

def test_use_seq_false_on_seq_mesh_rejected():
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    for make, kw in ((td.make_distributed_count, dict(k=5)),
                     (td.make_distributed_count_pairs, dict(k=5)),
                     (td.make_distributed_gapped, GAP),
                     (td.make_distributed_gapped_pairs, GAP)):
        with pytest.raises(ValueError, match="use_seq"):
            make(mesh, use_seq=False, **kw)
    with pytest.raises(ValueError, match="n_seq=1"):
        td.make_distributed_dense(mesh, k=5)


def test_split_batch_and_mesh_refuse_what_does_not_split():
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    codes, lengths, limits = _batch(1)
    with pytest.raises(ValueError, match="whole 16-base words"):
        split_batch(mesh, pack_batch_codes(codes[:, :96]).view(np.int32),
                    lengths, limits, packed_width=96)
    with pytest.raises(ValueError, match="data rows"):
        split_batch(mesh, codes[:3], lengths[:3], limits[:3])
    with pytest.raises(ValueError, match="mesh"):
        make_mesh(3, 3, devices=["cpu"] * 8)
    # u8 rows split in bases
    assert split_batch(mesh, codes[:, :100], lengths, limits).width == 25
