"""The gapped unfused route (ROADMAP item 17) and gapped windows over 31
bases (item 15), on the CPU against kmer_tpu, exactly (integer keys:
tolerance zero).

- the plain gapped_lanes (K7's gapped entry's plain version) equals
  kmer_tpu's gapped_lanes as the multiset of valid keys, at K3's split
  (l, r <= 31) and at the general layout of L||R past it;
- count_fasta(gapped=True, device="cpu") equals kmer_tpu.count_fasta at
  (40, 40) and (32, 5) on every sort-mode route;
- at 27/27 the unfused route (KMER_TPU_GAPPED_STEP=legacy, or
  sort_group_keys=0) gives K3's table, and the step selection follows
  kmer_tpu's _gapped_fused_ok without its TPU-only conditions.

kmer_tpu is imported only as the reference; inputs are made from seeds
with numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kmer_tpu
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops.extract import gapped_lanes as jax_gapped_lanes
import kmer_tpu_torch
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.ops.extract import gapped_lane_count, gapped_lanes
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import fused_gapped
from kmer_tpu_torch.pipeline.count import (batch_width, gapped_fused,
                                           gapped_step_sort)

WINDOWS = [(27, 27), (40, 40), (32, 5), (5, 32), (31, 33), (60, 60)]
ROUTES = {
    "default": ({}, {}),
    "compact": ({}, dict(compact=True)),
    "device_merge": ({}, dict(device_merge="on")),
    "sort_group_keys=0": ({}, dict(sort_group_keys=0)),
    "legacy": (dict(KMER_TPU_GAPPED_STEP="legacy"), {}),
    "legacy_pallas": (dict(KMER_TPU_GAPPED_STEP="legacy",
                           KMER_TPU_GROUPED="pallas"), {}),
}


def _batch(seed: int, B: int, L: int, short: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.003] = 4
    codes[0] = 3                                    # the all-T row
    lengths = rng.integers(short, L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    return codes, lengths, limits


@pytest.mark.parametrize("l_len,r_len", WINDOWS)
def test_gapped_lanes_equal_kmer_tpu(l_len, r_len):
    B, L = 7, 200
    c_min, c_max = l_len + r_len + 3, l_len + r_len + 30
    codes, lengths, limits = _batch(l_len * 100 + r_len, B, L, c_min - 5)
    jw, jv = jax.jit(jax_gapped_lanes, static_argnums=(2, 3, 4, 5),
                     static_argnames=("mask_ambiguous",))(
        jnp.asarray(codes), jnp.asarray(lengths), l_len, r_len, c_min,
        c_max, limits=jnp.asarray(limits), mask_ambiguous=True)
    jv = np.asarray(jv)
    want = np.stack([np.asarray(w)[jv] for w in jw], axis=1)
    planes, tv = gapped_lanes(torch.from_numpy(codes),
                              torch.from_numpy(lengths), l_len, r_len,
                              c_min, c_max, limits=torch.from_numpy(limits),
                              mask_ambiguous=True)
    bases = tenc.gapped_bases(l_len, r_len)
    assert len(planes) == len(bases)
    assert (bases == (l_len, r_len)) == (max(l_len, r_len) <= 31)
    assert planes[0].shape == (B, gapped_lane_count(L, c_min, c_max))
    tv = tv.numpy()
    got = tenc.planes_to_u32([p.numpy()[tv] for p in planes], bases)
    assert (sorted(map(tuple, got.tolist()))
            == sorted(map(tuple, want.tolist()))) and len(want) > 1000
    assert all((p.numpy()[~tv] == tenc.SENTINEL_KEY).all() for p in planes)


@pytest.mark.parametrize("l_len,r_len", [(27, 27), (40, 40)])
def test_k7_gapped_plain_packed_equals_u8(l_len, r_len):
    """K7's gapped entry's plain version reads packed rows as it reads u8
    rows, and is gapped_lanes lane for lane."""
    B, L = 5, 200
    codes, lengths, limits = _batch(3, B, L, 90)
    codes = codes & 3
    kw = dict(l_len=l_len, r_len=r_len, c_min=82, c_max=130)
    t = [torch.from_numpy(x) for x in (codes, lengths, limits)]
    u8 = ek.extract_gapped_keys(*t, **kw)
    packed = ek.extract_gapped_keys(
        torch.from_numpy(pack_batch_codes(codes).view(np.int32)), t[1],
        t[2], packed_width=L, **kw)
    want, _ = gapped_lanes(*t[:2], limits=t[2], **kw)
    assert len(u8) == len(packed) == len(want)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(u8, packed, want))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("gapped_unfused") / "g.fasta"
    path.write_text(genome_reads_fasta(25, 150, genome_len=1500, seed=21,
                                       error_rate=0.02))
    return str(path)


GEOMETRY = {(40, 40): dict(c_min=80, c_max=110),
            (32, 5): dict(c_min=40, c_max=75)}
SMALL = dict(batch_reads=8, max_read_len=128)


@pytest.fixture(scope="module")
def jax_tables(corpus):
    return {lr: kmer_tpu.count_fasta(corpus, kmer_tpu.KmerConfig(
        gapped=True, l_len=lr[0], r_len=lr[1], **g, **SMALL))
        for lr, g in GEOMETRY.items()}


@pytest.mark.parametrize("lr", list(GEOMETRY))
@pytest.mark.parametrize("route", list(ROUTES))
def test_wide_gapped_count_equals_kmer_tpu(corpus, jax_tables, monkeypatch,
                                           lr, route):
    env, extra = ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cfg = KmerConfig(gapped=True, l_len=lr[0], r_len=lr[1], **GEOMETRY[lr],
                     **SMALL, **extra)
    assert not gapped_fused(cfg.l_len, cfg.r_len, cfg.sort_group_keys)
    got = kmer_tpu_torch.count_fasta(corpus, cfg, device="cpu")
    assert got == jax_tables[lr] and got.num_distinct > 1000


@pytest.fixture(scope="module")
def k3_table(corpus):
    """The 27/27 table through K3 (the default route)."""
    return kmer_tpu_torch.count_fasta(corpus, KmerConfig(
        gapped=True, c_min=60, c_max=100, **SMALL), device="cpu")


@pytest.mark.parametrize("env,extra", [
    (dict(KMER_TPU_GAPPED_STEP="legacy"), {}),
    (dict(KMER_TPU_GAPPED_STEP="xla"), {}),
    ({}, dict(sort_group_keys=0)),
    (dict(KMER_TPU_GAPPED_STEP="legacy"), dict(compact=True)),
    (dict(KMER_TPU_GAPPED_STEP="legacy"), dict(device_merge="on")),
    (dict(KMER_TPU_GAPPED_STEP="legacy", KMER_TPU_GROUPED="hybrid"), {}),
    (dict(KMER_TPU_GAPPED_STEP="legacy"), dict(sort_group_keys=16))])
def test_unfused_route_equals_k3(corpus, k3_table, monkeypatch, env, extra):
    """Item 17 at the reference geometry's windows: K7's gapped lanes and
    the grouped counts (or K6's flat sort) give K3's table."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cfg = KmerConfig(gapped=True, c_min=60, c_max=100, **SMALL, **extra)
    assert not gapped_fused(cfg.l_len, cfg.r_len, cfg.sort_group_keys)
    got = kmer_tpu_torch.count_fasta(corpus, cfg, device="cpu")
    assert got == k3_table and got.total > 0


def test_step_selection(monkeypatch):
    """K3 under auto or fused with sort_group_keys > 0 and windows of at
    most 31 bases, with no residual-word or fit condition (8 + 8 bases, a
    whole uint32 word with no residual one, takes K3); every other case
    the unfused route, whose rows K3's MAX_ROW does not cap."""
    assert gapped_fused(27, 27, 256) and gapped_fused(31, 1, 1)
    assert gapped_fused(8, 8, 256)               # 2 n = 32: no residual
    assert not gapped_fused(32, 27, 256) and not gapped_fused(27, 27, 0)
    monkeypatch.setenv("KMER_TPU_GAPPED_STEP", "fused")
    assert gapped_fused(27, 27, 256) and not gapped_fused(27, 40, 256)
    monkeypatch.setenv("KMER_TPU_GAPPED_STEP", "legacy")
    assert not gapped_fused(27, 27, 256)
    long_row = np.array([0, 20_000], np.int64)
    cfg = KmerConfig(gapped=True, max_read_len=16_384)
    assert batch_width(long_row, cfg) == 16_384
    monkeypatch.delenv("KMER_TPU_GAPPED_STEP")
    assert batch_width(long_row, cfg) == fused_gapped.MAX_ROW


def test_gapped_step_outputs(monkeypatch):
    """K3's (B, T_pad) int8 output, and the unfused route's flat planes
    and int32 counts, count the same multiset."""
    codes, lengths, limits = _batch(8, 6, 150, 100)
    t = [torch.from_numpy(x) for x in (codes & 3, lengths, limits)]
    win = dict(c_min=60, c_max=90)
    hi, lo, c3 = gapped_step_sort(*t, **win)
    assert c3.dtype == torch.int8 and hi.dim() == 2
    monkeypatch.setenv("KMER_TPU_GAPPED_STEP", "legacy")
    *planes, c7 = gapped_step_sort(*t, **win)
    assert c7.dtype == torch.int32 and len(planes) == 2
    assert planes[0].dim() == 1

    def tally(words, counts):
        out = {}
        for key, n in zip(zip(*[w.reshape(-1).tolist() for w in words]),
                          counts.reshape(-1).tolist()):
            if n > 0:
                out[key] = out.get(key, 0) + n
        return out
    assert tally((hi, lo), c3) == tally(planes, c7)
    *wide, cw = gapped_step_sort(*t, l_len=40, r_len=5, c_min=50, c_max=60,
                                 group_keys=0)
    assert len(wide) == 2 and int(cw.sum()) > 0
