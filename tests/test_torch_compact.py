"""On-device compaction (kernel K4) and the compact counting path against
kmer_tpu, exactly (integer records and tables: tolerance zero), on
inputs from np.random.default_rng:

- compact_ref's records equal, as a multiset of (key, count), the rows
  kmer_tpu's compaction packs (its partition sort + pack_groups in
  interpret mode, and compact_from_runs) from the same K1 / K3 run
  streams, compared after records_from_tpu_rows;
- count_fasta(compact=True) on the CPU equals kmer_tpu's compact table
  and the port's own uncompacted one; the parity md5 holds compacted;
- `count --compact` writes kmer_tpu's bytes; config validation.
The CUDA kernel is held against compact_ref in test_torch_cuda.py.
"""

import hashlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops import count as C
from kmer_tpu.ops.pallas.compact import pack_groups, pack_groups_xla
from kmer_tpu.ops.pallas.fused_extract import fused_extract_count_T
from kmer_tpu.ops.pallas.fused_gapped import fused_gapped_count_T
import kmer_tpu_torch
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.ops.kernels import compact as ck
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.ops.kernels import fused_gapped as fg
from kmer_tpu_torch.pipeline.parity import SAMPLE_FASTA_MD5, parity_dump
from kmer_tpu_torch.pipeline.table import KmerTable, fuse_words

from test_torch_count import REPO, SMALL

PART_KEYS = 2048               # kmer_tpu's compact_from_runs default


def _batch(seed, B, L, *, empty=False, full=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B, dtype=np.int32)
    limits = rng.integers(1, L + 1, B, dtype=np.int32)
    if empty:
        lengths[:] = 0
    if full:
        lengths[:] = L
        limits[:] = L
    return codes, lengths, limits


def _tpu_pack(rflat, counts, interpret: bool):
    """kmer_tpu's compaction back half (ops/count.compact_from_runs
    :401-417) with pack_groups in interpret mode: (rows, total_rows)."""
    n = rflat[0].shape[0]
    pad = (-n) % PART_KEYS
    if pad:
        rflat = [jnp.concatenate([w, jnp.full((pad,), C.SENTINEL, w.dtype)])
                 for w in rflat]
        counts = jnp.concatenate([counts, jnp.zeros((pad,), counts.dtype)])
    G2 = (n + pad) // PART_KEYS
    live = counts > 0
    ops = [(~live).astype(jnp.uint32).reshape(G2, PART_KEYS)]
    ops += [w.reshape(G2, PART_KEYS) for w in rflat]
    ops.append(counts.astype(jnp.uint32).reshape(G2, PART_KEYS))
    part = lax.sort(tuple(ops), num_keys=1, dimension=1)
    d = jnp.sum(live.reshape(G2, PART_KEYS), axis=1, dtype=jnp.int32)
    fields = list(part[1:1 + len(rflat)]) + [part[-1]]
    if interpret:
        return pack_groups(fields, d, interpret=True)
    return pack_groups_xla(fields, d)


def _multiset(keys: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(key columns..., count) rows in a canonical order."""
    keys = keys.view(np.uint64)
    rows = np.column_stack([keys if keys.ndim == 2 else keys[:, None],
                            counts.astype(np.uint64)])
    return rows[np.lexsort(rows.T[::-1])]


def _tpu_records(rflat, counts, n_bases):
    """kmer_tpu's packed rows through pack_groups (interpret) and through
    compact_from_runs, both decoded by records_from_tpu_rows; they
    agree, and the first is returned."""
    out = []
    for rows, total in (_tpu_pack(rflat, counts, True),
                        C.compact_from_runs(rflat, counts,
                                            part_keys=PART_KEYS)):
        out.append(ck.records_from_tpu_rows(
            np.asarray(rows)[:int(total)], n_bases))
    np.testing.assert_array_equal(_multiset(*out[0]), _multiset(*out[1]))
    return out[0]


def _port_records(planes, counts, **kw):
    keys, cts, total = ck.compact_ref(planes, counts, **kw)
    t = int(total[0])
    assert keys.shape[0] == cts.shape[0] == counts.numel()
    assert cts.dtype == torch.int64
    return keys[:t].numpy(), cts[:t].numpy()


@pytest.mark.parametrize("k,canon,case", [(5, False, "random"),
                                          (21, True, "random"),
                                          (31, True, "random"),
                                          (21, False, "empty"),
                                          (21, True, "full")])
def test_k4_plain_equals_pallas_pack_k1_stream(k, canon, case):
    B, L, seg = 24, 62, 2                     # P = L - k + 1 even for odd k
    codes, lengths, limits = _batch(k + 7 * canon, B, L,
                                    empty=case == "empty",
                                    full=case == "full")
    rflat, jcounts = fused_extract_count_T(
        jnp.asarray(codes).T, jnp.asarray(lengths), jnp.asarray(limits), k,
        canonical=canon, seg=seg, block_lanes=128, algo="dedup",
        interpret=True)
    want = _tpu_records(rflat, jcounts, k)

    keys, counts = fe.fused_extract_count(
        *map(torch.from_numpy, (codes, lengths, limits)), k,
        canonical=canon, seg=seg)
    got = _port_records((keys,), counts)
    np.testing.assert_array_equal(_multiset(*got), _multiset(*want))
    n_live = int((counts > 0).sum())
    assert len(got[1]) == n_live and got[1].sum() == (counts.sum())
    if case == "empty":
        assert n_live == 0
    if case == "full":                        # every lane of every row live
        assert n_live == counts.numel()


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L", [
    (27, 27, 54, 60, 80),                     # the reference's windows, W=4
    (5, 5, 12, 20, 40),                       # a one-uint64 record (W=1)
])
def test_k4_plain_equals_pallas_pack_k3_stream(llen, rlen, cmin, cmax, L):
    B, nb = 10, llen + rlen
    codes, lengths, limits = _batch(llen + cmin, B, L)
    lengths[0] = limits[0] = L
    rflat, jcounts = fused_gapped_count_T(
        jnp.asarray(codes).T, jnp.asarray(lengths), jnp.asarray(limits),
        l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax, seg=2,
        block_lanes=128, algo="dedup", interpret=True)
    want = _tpu_records(rflat, jcounts, nb)

    hi, lo, counts = fg.fused_gapped_count(
        *map(torch.from_numpy, (codes, lengths, limits)), l_len=llen,
        r_len=rlen, c_min=cmin, c_max=cmax)
    got = _port_records((hi, lo), counts, r_len=rlen, n_bases=nb)
    assert got[0].ndim == (2 if nb > 31 else 1)
    np.testing.assert_array_equal(_multiset(*got), _multiset(*want))
    assert len(got[1]) > 0


def test_compact_ref_layout_and_edges():
    """Records keep lane order; a (hi, lo) pair becomes its value; no
    lanes give total 0; the wrapper takes only CPU or CUDA tensors."""
    hi = torch.tensor([[3, 1], [2, 1]], dtype=torch.int64)
    lo = torch.tensor([[7, 0], [5, 9]], dtype=torch.int64)
    counts = torch.tensor([[2, 0], [1, 3]], dtype=torch.int8)
    keys, cts, total = ck.compact((hi, lo), counts, r_len=2, n_bases=40)
    assert int(total[0]) == 3 and keys.shape == (4, 2)
    assert keys[:3].tolist() == [[0, 3 * 16 + 7], [0, 2 * 16 + 5],
                                 [0, 1 * 16 + 9]]
    assert cts[:3].tolist() == [2, 1, 3]
    w = (1 << 61) + 5                      # a 31-base window near the top
    keys, _, _ = ck.compact((torch.tensor([w]), torch.tensor([w])),
                            torch.ones(1, dtype=torch.int8), r_len=31,
                            n_bases=62)
    v = (w << 62) + w
    assert int(keys[0, 0]) == v >> 64
    assert int(keys[0, 1]) & ((1 << 64) - 1) == v & ((1 << 64) - 1)
    keys, cts, total = ck.compact((torch.zeros((0, 4), dtype=torch.int64),),
                                  torch.zeros((0, 4), dtype=torch.int8))
    assert int(total[0]) == 0 and keys.shape == (0,)
    meta = torch.zeros(4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ck.compact((meta.to(torch.int64),), meta)
    with pytest.raises(ValueError, match="r_len"):
        ck.compact_ref((hi, lo), counts, r_len=0)


def test_records_from_tpu_rows_word_layouts():
    """kmer_tpu's repacked words decode to the fused key for W = 1, 2
    (with and without residual bits) and W = 4."""
    rng = np.random.default_rng(3)
    for n_bases in (7, 16, 21, 54):
        W = ck.words_per_key(n_bases)
        std = [rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
               for _ in range(W)]
        top = 2 * n_bases - 32 * (W - 1)
        std[0] &= np.uint32((1 << top) - 1) if top < 32 else np.uint32(
            0xFFFFFFFF)
        valid = jnp.ones(50, bool)
        rw, _ = C.repack_words([jnp.asarray(w) for w in std], valid, n_bases)
        rec_w = ck.record_width(W + 1)
        rows = np.zeros((50, rec_w), np.uint32)
        for j, w in enumerate(rw):
            rows[:, j] = np.asarray(w)
        rows[:, W] = np.arange(1, 51)
        rows[::7, W] = 0                       # dead records are dropped
        keys, counts = ck.records_from_tpu_rows(rows, n_bases)
        live = rows[:, W] > 0
        want = fuse_words(np.stack(std, 1)[live], n_bases)
        np.testing.assert_array_equal(keys, want)
        np.testing.assert_array_equal(counts, rows[live, W])


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    p = tmp_path_factory.mktemp("compact") / "genome.fasta"
    p.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=11,
                                    error_rate=0.01))
    return str(p)


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [5, 21, 31])
def test_count_fasta_compact_tables(genome, k, canonical):
    want = kmer_tpu.count_fasta(genome, k=k, canonical=canonical,
                                compact=True, **SMALL)
    got = kmer_tpu_torch.count_fasta(genome, k=k, canonical=canonical,
                                     compact=True, device="cpu", **SMALL)
    plain = kmer_tpu_torch.count_fasta(genome, k=k, canonical=canonical,
                                       device="cpu", **SMALL)
    assert got == want and plain == got
    assert got.total == 300 * (150 - k + 1)


def test_gapped_compact_tables_and_parity(genome, sample_fasta_path):
    cfg = dict(gapped=True, c_min=56, c_max=64, batch_reads=32,
               max_read_len=128)
    want = kmer_tpu.count_fasta(genome, kmer_tpu.KmerConfig(compact=True,
                                                            **cfg))
    got = kmer_tpu_torch.count_fasta(genome, KmerConfig(compact=True, **cfg),
                                     device="cpu")
    assert got == want
    assert kmer_tpu_torch.count_fasta(genome, KmerConfig(**cfg),
                                      device="cpu") == got
    assert got.total == 300 * sum(150 - c + 1 for c in range(56, 65))
    pcfg = KmerConfig(gapped=True, batch_reads=256, max_read_len=512,
                      compact=True)
    dump = parity_dump(sample_fasta_path, pcfg, device="cpu")
    assert hashlib.md5(dump).hexdigest() == SAMPLE_FASTA_MD5


def test_from_compact_is_from_fused():
    keys = np.array([9, 3, 9, 1], np.int64)
    t = KmerTable.from_compact(7, keys, np.array([1, 2, 3, 4]))
    assert t.keys[:, 0].tolist() == [1, 3, 9]
    assert t.counts.tolist() == [4, 2, 4]


def test_cli_count_compact_bytes(genome, capsys):
    for extra in (["-k", "21", "--canonical"], ["--gapped", "--c-min", "60",
                                                "--c-max", "64"]):
        args = ["count", genome, *extra, "--compact", "--batch-reads", "64",
                "--max-read-len", "96"]
        assert jax_main(args) == 0
        want = capsys.readouterr().out
        res = subprocess.run(
            [sys.executable, "-m", "kmer_tpu_torch", *args, "--device",
             "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout == want and want.count("\n") > 100


def test_compact_config_validation():
    """kmer_tpu's test_compact_config_validation: keys of up to 111 bases
    (7 key words) compact, wider ones raise as in kmer_tpu."""
    KmerConfig(k=21, compact=True)
    KmerConfig(gapped=True, compact=True, max_read_len=512)
    KmerConfig(k=33, compact=True)
    KmerConfig(k=63, compact=True, canonical=True)
    with pytest.raises(ValueError, match="key words"):
        KmerConfig(k=120, compact=True)
    with pytest.raises(ValueError, match="sort"):
        KmerConfig(k=8, mode="dense", compact=True)
    KmerConfig(k=64, compact=True)
    KmerConfig(k=111, compact=True, canonical=True)
    with pytest.raises(ValueError, match="key words"):
        KmerConfig(k=112, compact=True)
