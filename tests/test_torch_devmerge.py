"""The device-resident table (ops/devmerge, pipeline/count.DeviceMerge)
and the link-aware policies against kmer_tpu, on the CPU, exactly (all
values are integers):

- merge_batch, grow_state, max_rows and the wire drain against
  kmer_tpu.ops.devmerge on the same states and batches, converted
  between the port's int64 words and kmer_tpu's uint32 words;
- count_fasta(..., device_merge="on") tables against kmer_tpu's and the
  port's host-merge tables (k up to 63, spaced seeds, gapped pairs),
  through growth, drains and the clamp; every merge's sort takes the
  key words at their widths and the counts as payload;
- a reset followed by a group larger than the state, against the
  independent oracle of kmer_tpu/utils/oracle.py;
- _devmerge_ok, effective_mode and the dense scatter policy against
  kmer_tpu's decisions for the same environment.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import random_reads_fasta
from kmer_tpu.ops import devmerge as jdm
from kmer_tpu.pipeline.count import _devmerge_ok as jax_devmerge_ok
from kmer_tpu.utils.oracle import oracle_count
import kmer_tpu_torch
from kmer_tpu_torch.ops import devmerge as dm
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, keys_i64_to_u32,
                                       keys_u32_to_i64, pairs_to_u32,
                                       u32_to_pairs)
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.pipeline import count as tcount
from kmer_tpu_torch.pipeline.table import KmerTable, reduce_fused, unfuse_words

from test_torch_count import REPO


class Layout:
    """One key layout in both packages: `n_planes` int64 planes in the
    port (a key of k bases, or a gapped l+r pair), words_per_key uint32
    words in kmer_tpu."""

    def __init__(self, k=0, l_len=0, r_len=0):
        self.k, self.l_len, self.r_len = k, l_len, r_len
        self.n_planes = 2 if l_len else 1

    def keys(self, rng, n, span=None):
        """n random keys as port planes (values below 2**span bits)."""
        if self.l_len:
            return [rng.integers(0, 1 << (2 * b), n)
                    for b in (self.l_len, self.r_len)]
        return [rng.integers(0, 1 << (span or 2 * self.k), n)]

    def to_u32(self, planes):
        if self.l_len:
            return pairs_to_u32(planes[0], planes[1], self.l_len, self.r_len)
        return keys_i64_to_u32(planes[0], self.k)

    def from_u32(self, words):
        if self.l_len:
            return np.stack(u32_to_pairs(words, self.l_len, self.r_len), 1)
        return keys_u32_to_i64(words, self.k).reshape(-1, 1)


LAYOUTS = {"k13": Layout(k=13), "k21": Layout(k=21), "k31": Layout(k=31),
           "gap5": Layout(l_len=5, r_len=5),
           "gap27": Layout(l_len=27, r_len=27)}


def _both_merge(lay, port, jax_state, planes, counts):
    """One merge in each package; returns the new states."""
    words = lay.to_u32(planes)
    jw, jc, jd = jdm.merge_batch(
        *jax_state, [jnp.asarray(words[:, j]) for j in
                     range(words.shape[1])],
        jnp.asarray(counts.astype(np.int32)))
    pw, pc, pd = dm.merge_batch(*port, [torch.from_numpy(p) for p in planes],
                                torch.from_numpy(counts))
    assert int(pd) == int(jd)
    jkeys, jcounts = jdm.fetch_state(jw, jc, int(jd))
    keys, cts = dm.fetch_state(pw, pc, int(pd))
    np.testing.assert_array_equal(keys, lay.from_u32(jkeys))
    np.testing.assert_array_equal(cts, jcounts)
    # the padding rows stay sentinel rows with count 0
    assert all(bool((w[int(pd):] == SENTINEL_KEY).all()) for w in pw)
    assert int(pc[int(pd):].abs().sum()) == 0
    return (pw, pc), (jw, jc)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_merge_batch_equals_kmer_tpu(name):
    """Merges across batches (dead lanes, duplicates, an all-dead batch,
    counts accumulating), with grow_state mid-stream."""
    lay = LAYOUTS[name]
    rng = np.random.default_rng(len(name) * 7 + lay.k)
    W = lay.to_u32(lay.keys(rng, 1)).shape[1]
    C = 1 << 11
    port = dm.empty_state(C, lay.n_planes)
    jax_state = jdm.empty_state(C, W)
    pool = lay.keys(rng, 300)
    for batch in range(6):
        if batch == 3:
            port = dm.grow_state(*port, 1 << 12)
            jax_state = jdm.grow_state(*jax_state, 1 << 12)
            assert port[1].numel() == 1 << 12
            assert dm.grow_state(*port, 16)[1].numel() == 1 << 12
        n = int(rng.integers(200, 600))
        pick = rng.integers(0, 300, n)
        planes = [p[pick].copy() for p in pool]
        counts = rng.integers(-1, 4, n)              # <= 0 is dead
        if batch == 2:
            counts[:] = 0                            # an all-dead batch
        port, jax_state = _both_merge(lay, port, jax_state, planes, counts)


def test_merge_counts_int64_past_2_31():
    """Counts are int64: totals past 2**31 merge exactly, no drain."""
    state = dm.empty_state(64, 1)
    big = (1 << 31) - 5
    keys = np.array([3, 3, 9, 3])
    for counts in (np.array([big, 4, 1, 0]), np.array([big, 7, 2, 2])):
        state = dm.merge_batch(*state, [torch.from_numpy(keys)],
                               torch.from_numpy(counts))[:2]
    k, c = dm.fetch_state(*state, 2)
    assert k[:, 0].tolist() == [3, 9]
    assert c.tolist() == [2 * big + 4 + 7 + 2, 3]


def test_merge_refuses_a_batch_larger_than_the_state():
    state = dm.empty_state(8, 1)
    with pytest.raises(ValueError, match="drop keys"):
        dm.merge_batch(*state, [torch.arange(9)], torch.ones(9))


def test_max_rows_budget(monkeypatch):
    monkeypatch.setenv("KMER_TPU_DEVMERGE_MAX_MB", "12")
    assert dm.max_rows(2) == 1 << 18           # 12e6 / 24 B = 500,000
    assert dm.max_rows(1) == 1 << 19           # 12e6 / 16 B = 750,000
    monkeypatch.setenv("KMER_TPU_DEVMERGE_MAX_MB", "bogus")
    assert dm.max_rows(1) == 1 << 25           # the 1024 MB default
    monkeypatch.setenv("KMER_TPU_DEVMERGE_MAX_MB", "0.0001")
    assert dm.max_rows(1) == 1 << 16           # the floor


def _sorted_state(lay, keys64, counts, C):
    """Both packages' states holding the sorted unique int64 `keys64`
    (key values; gapped pairs split at 2 * r_len bits)."""
    if lay.l_len:
        s = 2 * lay.r_len
        planes = [keys64 >> s, keys64 & ((1 << s) - 1)]
    else:
        planes = [keys64]
    words = lay.to_u32(planes)
    jax_state = jdm.merge_batch(
        *jdm.empty_state(C, words.shape[1]),
        [jnp.asarray(words[:, j]) for j in range(words.shape[1])],
        jnp.asarray(counts.astype(np.int32)))
    port = dm.merge_batch(*dm.empty_state(C, lay.n_planes),
                          [torch.from_numpy(p) for p in planes],
                          torch.from_numpy(counts))
    return port, jax_state


def _check_wire(lay, port, jax_state):
    pw, pc, pd = port
    raw = dm.fetch_state(pw, pc, pd)
    got = dm.fetch_state_wire(pw, pc, pd, l_len=lay.l_len, r_len=lay.r_len)
    assert got is not None
    np.testing.assert_array_equal(got[0], raw[0])
    np.testing.assert_array_equal(got[1], raw[1])
    want = jdm.fetch_state_wire(*jax_state)
    np.testing.assert_array_equal(got[0], lay.from_u32(want[0]))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name,bits", [("k13", 26), ("k21", 24),
                                       ("k21", 40), ("gap5", 20),
                                       ("gap27", 0), ("k31", 62)])
def test_wire_drain_equals_fetch_and_kmer_tpu(name, bits):
    """Dense and sparse tables, counts at and past 255, escapes in the
    first row and past 2**24 and 2**32."""
    lay = LAYOUTS[name]
    rng = np.random.default_rng(bits + len(name))
    n = 900
    if lay.l_len == 27:
        keys64 = None
        planes = lay.keys(rng, n)
        order = np.lexsort(planes[::-1])
        planes = [p[order] for p in planes]
    else:
        keys64 = np.unique(rng.integers(0, 1 << bits, n))
        keys64[-1] = (1 << bits) - 1
        n = len(keys64)
    counts = rng.integers(1, 4, n)
    counts[5], counts[6], counts[7] = 255, 256, 100_000
    if keys64 is not None:
        port, jax_state = _sorted_state(lay, keys64, counts, 1 << 11)
    else:
        words = lay.to_u32(planes)
        jax_state = jdm.merge_batch(
            *jdm.empty_state(1 << 11, 4),
            [jnp.asarray(words[:, j]) for j in range(4)],
            jnp.asarray(counts.astype(np.int32)))
        port = dm.merge_batch(*dm.empty_state(1 << 11, 2),
                              [torch.from_numpy(p) for p in planes],
                              torch.from_numpy(counts))
    _check_wire(lay, port, jax_state)


def test_wire_drain_u32_tier_and_overflow():
    """A sparse table overflows the u24 patch but fits the u32 tier; a
    table of gaps past 2**32 overflows both (None: fetch_state)."""
    lay = LAYOUTS["k31"]
    rng = np.random.default_rng(7)
    n = 100_000
    keys64 = np.unique(rng.choice(1 << 42, n, replace=False))
    counts = rng.integers(1, 4, len(keys64))
    counts[rng.choice(len(keys64), 300, replace=False)] = 70_000
    port, jax_state = _sorted_state(lay, keys64, counts, 1 << 17)
    enc = dm.wire_encode(port[0], port[1], int(port[2]))
    assert int(enc[5]) > dm.WIRE_PATCH_ROWS >= int(enc[6])
    _check_wire(lay, port, jax_state)
    sparse = np.arange(70_000, dtype=np.int64) << 33
    port = dm.merge_batch(*dm.empty_state(1 << 17, 1),
                          [torch.from_numpy(sparse)],
                          torch.ones(70_000, dtype=torch.int64))
    assert dm.fetch_state_wire(*port) is None


@pytest.mark.parametrize("seed", range(4))
def test_wire_drain_randomized_tiers(seed):
    rng = np.random.default_rng(1000 + seed)
    name = ["k13", "k21", "k31", "gap5"][seed]
    lay = LAYOUTS[name]
    top = 2 * (lay.l_len + lay.r_len) if lay.l_len else 2 * lay.k
    bits = int(rng.integers(16, top + 1))
    keys64 = np.unique(rng.integers(0, 1 << bits, int(rng.integers(200,
                                                                    3000))))
    counts = rng.integers(1, 300, len(keys64))
    counts[rng.integers(0, len(keys64), 5)] = 1_000_000
    port, jax_state = _sorted_state(lay, keys64, counts, 1 << 13)
    _check_wire(lay, port, jax_state)
    empty = dm.empty_state(64, lay.n_planes)
    got = dm.fetch_state_wire(*empty, 0, l_len=lay.l_len, r_len=lay.r_len)
    assert got[0].shape == (0, lay.n_planes) and got[1].shape == (0,)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("devmerge")
    paths = {}
    for name, n, length, seed in (("a", 37, 90, 11), ("b", 60, 64, 14)):
        p = d / f"{name}.fasta"
        p.write_text(random_reads_fasta(n, length, seed=seed))
        paths[name] = str(p)
    return paths


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [5, 15, 21, 31, 55, 63])
def test_count_fasta_devmerge_equals_kmer_tpu(reads, k, canonical):
    kw = dict(k=k, canonical=canonical, batch_reads=8, max_read_len=96)
    want = kmer_tpu.count_fasta(reads["a"], mode="sort", **kw)
    got = kmer_tpu_torch.count_fasta(reads["a"], device="cpu",
                                     device_merge="on", **kw)
    assert got == want and got.total == 37 * (90 - k + 1)
    assert kmer_tpu_torch.count_fasta(reads["a"], device="cpu",
                                      device_merge="off", **kw) == got


@pytest.mark.parametrize("win", [dict(l_len=5, r_len=5, c_min=12, c_max=16),
                                 dict(l_len=13, r_len=17, c_min=30,
                                      c_max=40)])
def test_gapped_count_devmerge_equals_kmer_tpu(reads, win):
    cfg = dict(gapped=True, batch_reads=8, max_read_len=96, **win)
    want = kmer_tpu.count_fasta(reads["a"], kmer_tpu.KmerConfig(**cfg))
    port_cfg = kmer_tpu_torch.KmerConfig(**cfg)
    got = kmer_tpu_torch.count_fasta(reads["a"], port_cfg.replace(
        device_merge="on"), device="cpu")
    assert got == want and got.total > 0
    assert kmer_tpu_torch.count_fasta(reads["a"], port_cfg,
                                      device="cpu") == got


@pytest.mark.parametrize("mask,canonical", [
    ("110101011", True), ("1110111011101110111011101110111", False),
    ("1110111011101110111011101110111011101110111011101110111", True)])
def test_spaced_count_devmerge_equals_kmer_tpu(reads, mask, canonical):
    """Spaced seeds of one key word and of a (hi, lo) pair through the
    device merge, whose sort now takes the counts as payload."""
    kw = dict(seed_mask=mask, canonical=canonical, batch_reads=8,
              max_read_len=96)
    want = kmer_tpu.count_fasta(reads["a"], kmer_tpu.KmerConfig(**kw))
    got = kmer_tpu_torch.count_fasta(reads["a"], kmer_tpu_torch.KmerConfig(
        **kw, device_merge="on"), device="cpu")
    assert got == want and got.total == 37 * (90 - len(mask) + 1)


@pytest.mark.parametrize("kw,bits", [
    (dict(k=21), (42,)), (dict(k=55), (62, 48)), (dict(k=63), (62, 64)),
    (dict(seed_mask="110101011"), (12,)),
    (dict(seed_mask="1110111011101110111011101110111011101110111011101110111"),
     (62, 22)),
    (dict(gapped=True, l_len=5, r_len=7, c_min=12, c_max=16), (10, 14))])
def test_devmerge_sorts_keys_with_counts_as_payload(reads, monkeypatch, kw,
                                                    bits):
    """Every merge sorts its W key words at the key's bits (k <= 31: 2k;
    a pair: 62 and 2 r_len, 64 at r_len = 32) with the counts as the
    payload word, as kmer_tpu's lax.sort(num_keys=W)."""
    seen = []
    orig = dm.sort_words

    def spy(words, num_keys=None, bits=None):
        seen.append((len(words), num_keys, bits))
        return orig(words, num_keys, bits)
    monkeypatch.setattr(dm, "sort_words", spy)
    cfg = kmer_tpu_torch.KmerConfig(batch_reads=8, max_read_len=96,
                                    device_merge="on", **kw)
    got = kmer_tpu_torch.count_fasta(reads["a"], cfg, device="cpu")
    assert got.total > 0 and seen
    assert set(seen) == {(len(bits) + 1, len(bits), bits)}


def _spy(monkeypatch, name):
    """Record the calls of devmerge.`name` (the new row counts)."""
    calls = []
    orig = getattr(dm, name)
    monkeypatch.setattr(dm, name, lambda w, c, n: calls.append(n) or orig(
        w, c, n))
    return calls


def _tiny_state(monkeypatch, rows=2048):
    orig = dm.empty_state
    monkeypatch.setattr(dm, "empty_state",
                        lambda r, w, device: orig(min(r, rows), w, device))


def test_devmerge_growth(reads, monkeypatch):
    """Distinct keys past the first capacity grow the state: one drain,
    the table exact."""
    kw = dict(k=15, batch_reads=8, max_read_len=64)
    want = kmer_tpu.count_fasta(reads["b"], mode="sort", **kw)
    _tiny_state(monkeypatch)
    grown = _spy(monkeypatch, "grow_state")
    drained = []
    orig_drain = tcount.DeviceMerge.drain
    monkeypatch.setattr(tcount.DeviceMerge, "drain",
                        lambda self: drained.append(1) or orig_drain(self))
    got = kmer_tpu_torch.count_fasta(reads["b"], device="cpu",
                                     device_merge="on", **kw)
    assert got == want and grown and len(drained) == 1


def test_devmerge_budget_cap_drains(reads, monkeypatch):
    """Past devmerge.max_rows the state drains and resets instead of
    growing; the parts merge on the host, exactly."""
    kw = dict(k=15, batch_reads=8, max_read_len=64)
    want = kmer_tpu.count_fasta(reads["b"], mode="sort", **kw)
    _tiny_state(monkeypatch)
    monkeypatch.setattr(dm, "max_rows", lambda w: 2048)
    grown = _spy(monkeypatch, "grow_state")
    got = kmer_tpu_torch.count_fasta(reads["b"], device="cpu",
                                     device_merge="on", **kw)
    assert got == want and not grown


@pytest.mark.parametrize("rows", ["512", "64"])
def test_devmerge_fixed_rows_drain_and_clamp(reads, monkeypatch, rows):
    """KMER_TPU_DEVMERGE_ROWS fixes the capacity: drains before nearly
    every merge (512), and an override below one batch's lanes is
    raised to them (64), never honoured at the cost of keys."""
    kw = dict(k=15, batch_reads=4, max_read_len=64)
    want = kmer_tpu.count_fasta(reads["b"], mode="sort", **kw)
    monkeypatch.setenv("KMER_TPU_DEVMERGE_ROWS", rows)
    got = kmer_tpu_torch.count_fasta(reads["b"], device="cpu",
                                     device_merge="on", **kw)
    assert got == want


def test_reset_then_group_larger_than_state(monkeypatch):
    """After a drain and reset, a pending group larger than the state
    grows it before the merge (kmer_tpu's pipeline would merge it
    unchecked and lose keys); the table equals the independent oracle."""
    rng = np.random.default_rng(21)
    k = 11
    monkeypatch.setenv("KMER_TPU_DEVMERGE_ROWS", "64")
    seqs = []
    dmg = tcount.DeviceMerge(
        1, torch.device("cpu"),
        lambda keys, counts: (keys[:, 0].copy().view(np.uint64), counts))
    for B in (2, 40):                  # 2 x 30 lanes, then 40 x 30
        codes = rng.integers(0, 4, (B, 40), dtype=np.uint8)
        seqs += ["".join("ACGT"[c] for c in row) for row in codes]
        keys, counts = fe.fused_extract_count(
            torch.from_numpy(codes), torch.full((B,), 40, dtype=torch.int32),
            torch.full((B,), 40, dtype=torch.int32), k)
        dmg.add((keys,), counts)
        if B == 2:
            assert dmg.capacity == 64 and dmg.fixed
    parts = dmg.finish()
    assert len(parts) == 2 and dmg.capacity >= 40 * 30
    fused, counts = reduce_fused(np.concatenate([f for f, _ in parts]),
                                 np.concatenate([c for _, c in parts]))
    got = KmerTable(k, unfuse_words(fused, k), counts).to_dict()
    assert got == dict(oracle_count(seqs, k))


ENVS = [{}, {"KMER_TPU_D2H_GBPS": "0.1"}, {"KMER_TPU_D2H_GBPS": "3"},
        {"KMER_TPU_D2H_GBPS": "100"},
        {"KMER_TPU_D2H_GBPS": "3", "KMER_TPU_DENSE_LINK_GBPS": "2"},
        {"KMER_TPU_DEVMERGE": "1"}, {"KMER_TPU_DEVMERGE": "0"},
        {"KMER_TPU_D2H_GBPS": "0.1", "KMER_TPU_DEVMERGE_LINK_GBPS": "0.05"},
        {"KMER_TPU_DENSE_SCATTER": "1"}, {"KMER_TPU_DENSE_SCATTER": "0"},
        {"KMER_TPU_D2H_GBPS": "0.3"}]


@pytest.mark.parametrize("env", ENVS)
def test_policies_equal_kmer_tpu(monkeypatch, env):
    from kmer_tpu.utils import linkspeed as jls
    from kmer_tpu_torch.utils import linkspeed as tls
    for name in ("KMER_TPU_D2H_GBPS", "KMER_TPU_DENSE_LINK_GBPS",
                 "KMER_TPU_DEVMERGE", "KMER_TPU_DEVMERGE_LINK_GBPS",
                 "KMER_TPU_DENSE_SCATTER", "KMER_TPU_SCATTER_LINK_GBPS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for mode in ("auto", "on", "off"):
        jcfg = kmer_tpu.KmerConfig(device_merge=mode)
        cfg = kmer_tpu_torch.KmerConfig(device_merge=mode)
        assert tcount._devmerge_ok(cfg, "cpu") == jax_devmerge_ok(jcfg)
    for kw in (dict(k=5), dict(k=8), dict(k=9), dict(k=5, compact=True),
               dict(k=12, mode="dense"), dict(k=21, mode="sort"),
               dict(gapped=True)):
        assert (kmer_tpu_torch.KmerConfig(**kw).effective_mode
                == kmer_tpu.KmerConfig(**kw).effective_mode)
    assert tls.dense_scatter_ok() == jls.dense_scatter_ok()
    assert tls.dense_auto_ok() == jls.dense_auto_ok()


def test_link_probe_on_cpu_and_override(monkeypatch):
    from kmer_tpu_torch.utils import linkspeed as tls
    monkeypatch.delenv("KMER_TPU_D2H_GBPS", raising=False)
    assert tls.d2h_gbps("cpu") == float("inf")
    monkeypatch.setenv("KMER_TPU_D2H_GBPS", "0.25")
    assert tls.d2h_gbps("cpu") == 0.25
    assert tcount._devmerge_ok(kmer_tpu_torch.KmerConfig(), "cpu") is False


def test_cli_device_merge_bytes(reads, capsys):
    args = ["count", reads["a"], "-k", "15", "--batch-reads", "8",
            "--max-read-len", "96", "--device-merge", "on"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    res = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout == want and want.count("\n") > 1000
