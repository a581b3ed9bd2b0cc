"""The unfused count step end to end: kmer_tpu_torch.count_fasta on the
CPU (the plain versions of K7, K2a-c, K6 and K4) under every step
setting -- KMER_TPU_STEP, KMER_TPU_GROUPED, sort_group_keys, with
compact=True and with device_merge="on" -- gives kmer_tpu's table; and
sort_group_keys is honoured as in kmer_tpu: 0 takes one flat sort
(sort_count) and no device merge, compact keeps the fused step under
auto, dense mode never leaves the fused step.
"""

import numpy as np
import pytest
import torch

import kmer_tpu
import kmer_tpu_torch
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu_torch.ops import count as count_ops
from kmer_tpu_torch.ops import devmerge
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.pipeline import count as pipe

SMALL = dict(batch_reads=64, max_read_len=96)

# (name, environment, KmerConfig overrides)
SETTINGS = [
    *[(f"legacy-{b}", dict(KMER_TPU_STEP="legacy", KMER_TPU_GROUPED=b), {})
      for b in count_ops.GROUPED_BACKENDS],
    ("t", dict(KMER_TPU_STEP="t"), {}),
    ("t-m4", dict(KMER_TPU_STEP="t", KMER_TPU_T_M="4"), {}),
    ("legacy-g64", dict(KMER_TPU_STEP="legacy"), dict(sort_group_keys=64)),
    ("legacy-g0", dict(KMER_TPU_STEP="legacy"), dict(sort_group_keys=0)),
    ("auto-g0", {}, dict(sort_group_keys=0)),
    ("legacy-compact", dict(KMER_TPU_STEP="legacy"), dict(compact=True)),
    ("legacy-compact-g128-pallas",
     dict(KMER_TPU_STEP="legacy", KMER_TPU_GROUPED="pallas"),
     dict(compact=True, sort_group_keys=128)),
    ("auto-compact-g0", {}, dict(compact=True, sort_group_keys=0)),
    ("legacy-devmerge", dict(KMER_TPU_STEP="legacy"),
     dict(device_merge="on")),
    ("t-devmerge", dict(KMER_TPU_STEP="t"), dict(device_merge="on")),
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("unfused")
    g = d / "genome.fasta"
    g.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=4,
                                    error_rate=0.01))
    return str(g)


@pytest.fixture(scope="module")
def jax_tables(corpus):
    """kmer_tpu's table of the corpus by (k, canonical), computed once:
    kmer_tpu's tables do not depend on the step settings."""
    cache = {}

    def get(k, canonical):
        if (k, canonical) not in cache:
            cache[k, canonical] = kmer_tpu.count_fasta(
                corpus, k=k, canonical=canonical, mode="sort", **SMALL)
        return cache[k, canonical]
    return get


@pytest.mark.parametrize("name,env,cfg", SETTINGS,
                         ids=[s[0] for s in SETTINGS])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [11, 15, 21, 31])
def test_unfused_tables_equal_kmer_tpu(corpus, jax_tables, monkeypatch, k,
                                       canonical, name, env, cfg):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = kmer_tpu_torch.count_fasta(corpus, k=k, canonical=canonical,
                                     device="cpu", **SMALL, **cfg)
    want = jax_tables(k, canonical)
    assert got == want and got.total == want.total > 0


class _Calls:
    """Wraps a function and counts its calls."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args, **kw):
        self.n += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("step", ["auto", "fused", "legacy", "t"])
def test_group_keys_zero_takes_sort_count(corpus, monkeypatch, step):
    """sort_group_keys=0: K7 then one flat sort on every step setting,
    and no device merge even when asked for."""
    monkeypatch.setenv("KMER_TPU_STEP", step)
    sort_count = _Calls(count_ops.sort_count)
    grouped = _Calls(count_ops.grouped_count)
    fused = _Calls(pipe.fused_extract_count)
    merge = _Calls(devmerge.merge_batch)
    monkeypatch.setattr(count_ops, "sort_count", sort_count)
    monkeypatch.setattr(count_ops, "grouped_count", grouped)
    monkeypatch.setattr(pipe, "fused_extract_count", fused)
    monkeypatch.setattr(devmerge, "merge_batch", merge)
    t = kmer_tpu_torch.count_fasta(corpus, k=21, canonical=True,
                                   device="cpu", sort_group_keys=0,
                                   device_merge="on", **SMALL)
    batches = -(-300 * 2 // 64)            # two rows a read
    assert t.total == 300 * 130
    assert (sort_count.n, grouped.n, fused.n, merge.n) == (batches, 0, 0, 0)


@pytest.mark.parametrize("step,group_keys,want", [
    ("auto", 256, "fused"), ("fused", 64, "fused"), ("legacy", 256, "hybrid"),
    ("legacy", 64, "hybrid"), ("t", 256, "pallas_t"), ("anything", 8,
                                                       "hybrid")])
def test_step_selection(corpus, monkeypatch, step, group_keys, want):
    """KMER_TPU_STEP and sort_group_keys select the step as kmer_tpu's
    count_step_sort does; the unfused steps extract through K7."""
    monkeypatch.setenv("KMER_TPU_STEP", step)
    seen = []
    orig = count_ops._sorted_grouped_runs

    def runs(words, group_keys, backend):
        seen.append((count_ops._resolve_backend(
            backend, len(words), group_keys), group_keys))
        return orig(words, group_keys, backend)
    fused = _Calls(pipe.fused_extract_count)
    extract = _Calls(pipe.extract_keys)
    monkeypatch.setattr(count_ops, "_sorted_grouped_runs", runs)
    monkeypatch.setattr(pipe, "fused_extract_count", fused)
    monkeypatch.setattr(pipe, "extract_keys", extract)
    kmer_tpu_torch.count_fasta(corpus, k=21, device="cpu",
                               sort_group_keys=group_keys, **SMALL)
    batches = -(-300 * 2 // 64)
    if want == "fused":
        assert (fused.n, extract.n, seen) == (batches, 0, [])
    else:
        m = pipe.T_GROUP_KEYS if want == "pallas_t" else group_keys
        assert (fused.n, extract.n) == (0, batches)
        assert seen == [(want, m)] * batches


def test_compact_keeps_fused_under_auto(corpus, monkeypatch):
    """kmer_tpu's count_step_compact ignores sort_group_keys under auto;
    under legacy it counts groups of max(sort_group_keys, 1) keys."""
    fused = _Calls(pipe.fused_extract_count)
    monkeypatch.setattr(pipe, "fused_extract_count", fused)
    kw = dict(k=21, canonical=True, device="cpu", compact=True, **SMALL)
    a = kmer_tpu_torch.count_fasta(corpus, sort_group_keys=0, **kw)
    assert fused.n == -(-300 * 2 // 64)
    monkeypatch.setenv("KMER_TPU_STEP", "legacy")
    b = kmer_tpu_torch.count_fasta(corpus, sort_group_keys=0, **kw)
    assert fused.n == -(-300 * 2 // 64) and a == b


@pytest.mark.parametrize("k,scatter", [(8, "0"), (11, "0"), (11, "1")])
def test_dense_ignores_step(corpus, jax_tables, monkeypatch, k, scatter):
    """Dense mode calls the fused step directly, whatever KMER_TPU_STEP
    and sort_group_keys say."""
    monkeypatch.setenv("KMER_TPU_STEP", "legacy")
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", scatter)
    extract = _Calls(pipe.extract_keys)
    monkeypatch.setattr(pipe, "extract_keys", extract)
    got = kmer_tpu_torch.count_fasta(corpus, k=k, canonical=True,
                                     mode="dense", sort_group_keys=0,
                                     device="cpu", **SMALL)
    assert got == jax_tables(k, True) and extract.n == 0


def test_bad_settings_raise(corpus, monkeypatch):
    with pytest.raises(ValueError, match="sort_group_keys"):
        kmer_tpu_torch.KmerConfig(sort_group_keys=-1)
    monkeypatch.setenv("KMER_TPU_STEP", "t")
    monkeypatch.setenv("KMER_TPU_T_M", "12")
    with pytest.raises(ValueError, match="KMER_TPU_T_M"):
        kmer_tpu_torch.count_fasta(corpus, k=21, device="cpu", **SMALL)
    monkeypatch.setenv("KMER_TPU_STEP", "legacy")
    monkeypatch.setenv("KMER_TPU_GROUPED", "hash1")
    with pytest.raises(ValueError, match="KMER_TPU_GROUPED"):
        kmer_tpu_torch.count_fasta(corpus, k=21, device="cpu", **SMALL)


def test_unfused_step_outputs(monkeypatch):
    """The unfused step's contract: flat int64 keys and int32 counts,
    padded to a multiple of the group size; K7 counts no launch on the
    CPU."""
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 4, (10, 50), dtype=np.uint8))
    lens = torch.full((10,), 50, dtype=torch.int32)
    monkeypatch.setenv("KMER_TPU_STEP", "legacy")
    before = ek.launches
    keys, counts = pipe.count_step_sort(codes, lens, lens, k=21,
                                        canonical=False, group_keys=64)
    assert keys.dtype == torch.int64 and counts.dtype == torch.int32
    assert keys.shape == counts.shape == (-(-10 * 30 // 64) * 64,)
    assert int(counts.sum()) == 300 and ek.launches == before
