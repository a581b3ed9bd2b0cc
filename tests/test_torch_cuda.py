"""The CUDA kernels K1, K2a-c, K3, K4, K5, K6 and K7 against their plain
torch versions (K1 and K7 also for keys of 32 to 63 bases and for spaced
seeds, K4 and K5 also on (hi, lo) pairs, K5 on W planes), and the whole
count (sort, the unfused steps, compact, device merge and dense, at
k <= 31, at 32 <= k <= 63, at any width and with seed masks), the parity
dump, the HyperLogLog estimate (k = 101 too), streaming, BGZF ingest,
`count --profile-dir` and the mesh of positions on one card (in a
one-rank NCCL group too; k = 101 and gapped 40/40) on the card against
the CPU.  Every test
here needs a GPU and skips without one.  This file imports neither jax nor kmer_tpu,
so it also runs on a machine that has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import kmer_tpu_torch
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops.encode import SENTINEL_KEY, word_bases, words64
from kmer_tpu_torch.io.generator import (genome_reads_fasta,
                                         reference_style_fasta)
from kmer_tpu_torch.ops.kernels import compact as ck
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.ops.kernels import fused_gapped as fg
from kmer_tpu_torch.ops.kernels import grouped_count as gk
from kmer_tpu_torch.ops.kernels import histogram as hk
from kmer_tpu_torch.ops.kernels import sort as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k,canon,amb,seg,packed,L",
                         [(21, True, False, 2, True, 78),
                          (21, False, True, 8, False, 78),
                          (16, True, False, 2, True, 78),
                          (31, True, True, 4, False, 78),
                          (5, False, False, 16, True, 78),
                          (1, True, False, 2, True, 78),
                          # two-word keys, rows of 176 and 77 bases
                          (32, True, False, 2, True, 176),
                          (32, False, True, 4, False, 77),
                          (55, True, True, 16, False, 176),
                          (55, True, False, 2, True, 77),
                          (63, False, False, 8, True, 176),
                          (63, True, True, 2, False, 77)])
def test_kernel_equals_plain(cuda, k, canon, amb, seg, packed, L):
    rng = np.random.default_rng(k + seg)
    B = 300                           # P = L + 1 - k: odd and even segments
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = 0                   # zero-length padding rows
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    host = [torch.from_numpy(pack_batch_codes(codes).view(np.int32)
                             if packed else codes),
            torch.from_numpy(lengths), torch.from_numpy(limits)]
    kw = dict(canonical=canon, mask_ambiguous=amb, seg=seg,
              packed_width=L if packed else 0)
    want_keys, want_counts = fe.fused_extract_count(*host, k, **kw)
    before = fe.launches
    keys, counts = fe.fused_extract_count(*(t.to(cuda) for t in host), k,
                                          **kw)
    torch.cuda.synchronize()
    assert fe.launches == before + 1
    assert _same_keys(keys, want_keys)
    assert torch.equal(counts.cpu(), want_counts)


def test_wrapper_checks_inputs(cuda):
    codes = torch.zeros((4, 40), dtype=torch.uint8, device=cuda)
    lens = torch.full((4,), 40, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fe.fused_extract_count(codes.t().contiguous().t(), lens, lens, 21)
    with pytest.raises(ValueError, match="lengths"):
        fe.fused_extract_count(codes, lens.cpu(), lens, 21)
    with pytest.raises(ValueError, match="int32"):
        fe.fused_extract_count(codes.to(torch.int32), lens, lens, 21)


def test_count_fasta_cuda_equals_cpu(cuda, tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=1,
                                       error_rate=0.01))
    kw = dict(k=21, canonical=True, batch_reads=64, max_read_len=96)
    want = kmer_tpu_torch.count_fasta(str(path), device="cpu", **kw)
    fe.launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), device="cuda", **kw)
    assert got == want and got.total == 300 * 130
    # 150-base reads in 96-base rows: two rows a read, 64 rows a batch
    assert fe.launches == -(-300 * 2 // 64)


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb,seg,packed", [
    (27, 27, 80, 140, 416, False, 2, True),    # the parity shape
    (13, 9, 30, 40, 64, False, 4, True),       # asymmetric windows
    (27, 27, 80, 140, 300, True, 2, False),    # u8 rows, ambiguous codes
    (13, 9, 30, 40, 36, True, 8, False),       # c_max > L
    (5, 5, 10, 30, 57, False, 16, True),       # many chunk sizes a tile
    (27, 27, 54, 60, 96, True, 16, False),
])
def test_gapped_kernel_equals_plain(cuda, llen, rlen, cmin, cmax, L, amb,
                                    seg, packed):
    rng = np.random.default_rng(L + seg)
    B = 70
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.01] = 4
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = 0                   # zero-length padding rows
    lengths[3:6] = L
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    limits[3:6] = L
    host = [torch.from_numpy(pack_batch_codes(codes).view(np.int32)
                             if packed else codes),
            torch.from_numpy(lengths), torch.from_numpy(limits)]
    kw = dict(l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax,
              mask_ambiguous=amb, seg=seg, packed_width=L if packed else 0)
    want = fg.fused_gapped_count(*host, **kw)
    before = fg.launches
    got = fg.fused_gapped_count(*(t.to(cuda) for t in host), **kw)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[2] > 0).sum()) > 0


@pytest.mark.parametrize("B,L,win,amb,seg,packed,full", [
    # a ragged flat tail: B * T_pad no multiple of a warp's 512-lane piece
    (5, 100, (5, 4, 10, 90), False, 2, True, False),
    # rows much shorter than a piece: one piece spans hundreds of rows
    (700, 12, (3, 2, 11, 14), True, 2, False, False),
    (999, 90, (27, 27, 90, 140), False, 2, True, False),
    # rows of 12,288 bases: packed (read from L1), u8 staged, u8 with
    # ambiguity words (past the staging cap, read from the rows)
    (2, 12288, (27, 27, 80, 140), False, 2, True, True),
    (2, 12288, (27, 27, 80, 140), False, 4, False, True),
    (2, 12288, (27, 27, 80, 140), True, 16, False, False),
    # one chunk size near the row's end: a piece spans many wide rows
    (9, 12250, (31, 31, 12240, 12288), True, 4, False, False),
    # seg 16 through the out slots, u8 rows with ambiguity
    (64, 416, (27, 27, 80, 140), True, 16, False, False),
    (64, 416, (27, 27, 80, 140), False, 8, True, True),
])
def test_gapped_kernel_edges(cuda, B, L, win, amb, seg, packed, full):
    rng = np.random.default_rng(B + L + seg)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.01] = 4
    if full:
        lengths = np.full(B, L, np.int32)
        limits = np.full(B, L, np.int32)
    else:
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        limits = rng.integers(1, L + 1, B).astype(np.int32)
        lengths[-1], limits[-1] = L, L      # one full row, clean, has lanes
        codes[-1] &= 3
    host = [torch.from_numpy(pack_batch_codes(codes).view(np.int32)
                             if packed else codes),
            torch.from_numpy(lengths), torch.from_numpy(limits)]
    llen, rlen, cmin, cmax = win
    kw = dict(l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax,
              mask_ambiguous=amb, seg=seg, packed_width=L if packed else 0)
    on_dev = [t.to(cuda) for t in host]
    before = fg.launches
    got = fg.fused_gapped_count(*on_dev, **kw)
    want = fg.fused_gapped_count_ref(*on_dev, **kw)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((want[2] > 0).sum()) > 0
    info = fg.launch_info(B, L, l_len=llen, r_len=rlen, c_min=cmin,
                          c_max=cmax, seg=seg, mask_ambiguous=amb,
                          packed=packed)
    assert info["blocks"] >= 1 and info["blocks_per_sm"] >= 1


def test_gapped_kernel_no_lanes(cuda):
    """A row narrower than c_min has no lanes: an empty result and no
    launch."""
    codes = torch.zeros((8, 60), dtype=torch.uint8, device=cuda)
    lens = torch.full((8,), 60, dtype=torch.int32, device=cuda)
    before = fg.launches
    hi, lo, counts = fg.fused_gapped_count(codes, lens, lens, l_len=27,
                                           r_len=27, c_min=80, c_max=140)
    assert hi.shape == lo.shape == counts.shape == (8, 0)
    assert fg.launches == before


def test_gapped_count_and_parity_cuda_equal_cpu(cuda, tmp_path):
    path = tmp_path / "r.fasta"
    path.write_text(reference_style_fasta(n_records=40, seed=5))
    cfg = kmer_tpu_torch.KmerConfig(gapped=True, batch_reads=16,
                                    max_read_len=512)
    want = kmer_tpu_torch.count_fasta(str(path), cfg, device="cpu")
    fg.launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), cfg, device="cuda")
    assert got == want and got.total == 40 * 17751
    assert fg.launches == 3           # 40 records, 16 rows a batch
    assert (kmer_tpu_torch.parity_dump(str(path), cfg, device="cuda")
            == kmer_tpu_torch.parity_dump(str(path), cfg, device="cpu"))


def _k1_stream(dev, seed, B, L, k, *, empty=False):
    """K1's (keys, counts) on `dev` for random full-length reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = np.full(B, 0 if empty else L, np.int32)
    limits = np.full(B, L, np.int32)
    return fe.fused_extract_count(
        *(torch.from_numpy(a).to(dev) for a in (codes, lengths, limits)), k,
        canonical=True)


def _compact_both(planes, counts, **kw):
    before = ck.launches
    got = ck.compact(planes, counts, **kw)
    want = ck.compact_ref(planes, counts, **kw)
    torch.cuda.synchronize()
    t = int(want[2][0])
    assert int(got[2][0]) == t
    assert torch.equal(got[0][:t], want[0][:t])
    assert torch.equal(got[1][:t], want[1][:t])
    return ck.launches - before, t


@pytest.mark.parametrize("B,L,k", [(8192, 160, 21),   # the main path's shape
                                   (300, 78, 5), (999, 77, 31),
                                   (37, 40, 16)])     # a ragged last tile
def test_compact_kernel_equals_plain_k1(cuda, B, L, k):
    keys, counts = _k1_stream(cuda, B + k, B, L, k)
    launched, t = _compact_both((keys,), counts)
    assert launched == 1 and t == int((counts > 0).sum()) > 0


def test_compact_kernel_edges(cuda):
    keys, counts = _k1_stream(cuda, 1, 64, 50, 21, empty=True)
    launched, t = _compact_both((keys,), counts)
    assert launched == 1 and t == 0                    # no live lane
    ones = torch.ones(5000, dtype=torch.int8, device=cuda)
    keys = torch.arange(5000, dtype=torch.int64, device=cuda)
    launched, t = _compact_both((keys,), ones)
    assert t == 5000                                   # every lane live
    empty = torch.zeros((8, 0), dtype=torch.int64, device=cuda)
    before = ck.launches
    out = ck.compact((empty,), empty.to(torch.int8))
    assert ck.launches == before and int(out[2][0]) == 0


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L", [(27, 27, 80, 140, 416),
                                                   (5, 5, 12, 20, 64)])
def test_compact_kernel_equals_plain_k3(cuda, llen, rlen, cmin, cmax, L):
    rng = np.random.default_rng(L)
    B = 256
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = np.full(B, L - 16, np.int32)
    limits = np.full(B, L, np.int32)
    hi, lo, counts = fg.fused_gapped_count(
        *(torch.from_numpy(a).to(cuda) for a in (codes, lengths, limits)),
        l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax)
    launched, t = _compact_both((hi, lo), counts, r_len=rlen,
                                n_bases=llen + rlen)
    assert launched == 1 and t > 0


@pytest.mark.parametrize("bits", [8, 15, 16])
def test_histogram_kernel_equals_plain(cuda, bits):
    rng = np.random.default_rng(bits)
    n = 1_150_000                                      # one k=21 batch
    idx = torch.from_numpy(rng.integers(-3, (1 << bits) + 3, n)).to(cuda)
    w = torch.from_numpy(rng.integers(0, 4, n).astype(np.int8)).to(cuda)
    out = torch.full((1 << bits,), 7, dtype=torch.int64, device=cuda)
    before = hk.launches
    got = hk.index_histogram(idx, w, bits, out=out.clone())
    want = hk.index_histogram_ref(idx, w, bits, out=out.clone())
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,b", [(21, 10), (11, 11), (16, 4), (45, 10),
                                 (63, 11)])
def test_hll_histogram_kernel_equals_plain(cuda, k, b):
    keys, counts = _k1_stream(cuda, k, 2048, 150, k)
    got = hk.hll_class_histogram(keys, counts, k=k, b=b)
    want = hk.hll_class_histogram_ref(keys, counts, k=k, b=b)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.sum()) == int(counts.sum())


def test_histogram_kernel_empty(cuda):
    before = hk.launches
    got = hk.index_histogram(torch.zeros(0, dtype=torch.int64, device=cuda),
                             torch.zeros(0, dtype=torch.int8, device=cuda), 8)
    assert hk.launches == before and int(got.abs().sum()) == 0


def _histogram_both(idx, w, bits, out=None, grid=None):
    """K5 and its plain version on the same lanes; both accumulate into a
    copy of `out` (zeros when None).  Asserts one launch; returns both."""
    if out is None:
        out = torch.zeros(1 << bits, dtype=torch.int64, device=idx.device)
    before = hk.launches
    got = hk._launch(idx, w, bits, out.clone(), 0, 0, grid)
    want = hk.index_histogram_ref(idx, w, bits, out=out.clone())
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    return got, want


@pytest.mark.parametrize("bits", [8, 16])
def test_histogram_kernel_hot_bin(cuda, bits):
    """Every lane in bin 0 at weight 127: the bin passes 2**31 across
    clusters (no cluster's int32 bin may), in an int64 out."""
    n = 17_000_000
    idx = torch.zeros(n, dtype=torch.int64, device=cuda)
    w = torch.full((n,), 127, dtype=torch.int8, device=cuda)
    assert hk.plan(n, bits, hk._sm_count(0)).clusters > 1
    got, want = _histogram_both(idx, w, bits)
    assert int(got[0]) == 127 * n > 1 << 31 and torch.equal(got, want)


@pytest.mark.parametrize("bits", range(1, 17))
def test_histogram_kernel_bits_sweep(cuda, bits):
    """Indices around [0, 2**bits) (out-of-range ones dropped), weights
    over all of int8."""
    rng = np.random.default_rng(100 + bits)
    n = 300_007
    idx = torch.from_numpy(rng.integers(-2, (1 << bits) + 2, n)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(cuda)
    got, want = _histogram_both(idx, w, bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [4, 15, 16])
def test_histogram_kernel_negative_weights(cuda, bits):
    rng = np.random.default_rng(bits)
    n = 1_146_880
    idx = torch.from_numpy(rng.integers(0, 1 << bits, n)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 0, n).astype(np.int8)).to(cuda)
    got, want = _histogram_both(idx, w, bits)
    assert torch.equal(got, want) and int(got.sum()) == int(w.sum()) < 0


# (key slice, weight slice): views whose 16-byte alignment differs from
# the allocation's, and keys not aligned with their weights
VIEWS = [(slice(1, None), slice(1, None)), (slice(3, -5), slice(3, -5)),
         (slice(1, None), slice(0, -1)), (slice(0, -7), slice(7, None)),
         (slice(15, None), slice(15, None))]


@pytest.mark.parametrize("ks,ws", VIEWS)
@pytest.mark.parametrize("bits", [8, 16])
def test_histogram_kernel_unaligned_views(cuda, ks, ws, bits):
    rng = np.random.default_rng(bits)
    n = 100_000
    idx = torch.from_numpy(rng.integers(0, 1 << bits, n)).to(cuda)[ks]
    w = torch.from_numpy(rng.integers(1, 4, n).astype(np.int8)).to(cuda)[ws]
    got, want = _histogram_both(idx, w, bits)
    assert torch.equal(got, want) and int(got.sum()) == int(w.sum())


@pytest.mark.parametrize("ks,ws", VIEWS)
@pytest.mark.parametrize("k", [21, 55])
def test_hll_histogram_kernel_unaligned_views(cuda, ks, ws, k):
    keys, counts = _k1_stream(cuda, k, 512, 150, k)
    planes = keys if isinstance(keys, tuple) else (keys,)
    planes = tuple(p[ks] for p in planes)
    counts = counts[ws]
    keys = planes if k > 31 else planes[0]
    got = hk.hll_class_histogram(keys, counts, k=k, b=10)
    want = hk.hll_class_histogram_ref(keys, counts, k=k, b=10)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.sum()) == int(counts.sum())


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 33, 8191, 8192, 8193,
                               16385, 286_721])
@pytest.mark.parametrize("bits", [8, 15, 16])
def test_histogram_kernel_lane_counts(cuda, n, bits):
    """n from one lane up to one past a block's share of an iteration
    (512 threads x 16 lanes) and past a 2048-read batch."""
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.integers(0, 1 << bits, n)).to(cuda)
    w = torch.from_numpy(rng.integers(-3, 4, n).astype(np.int8)).to(cuda)
    got, want = _histogram_both(idx, w, bits)
    assert torch.equal(got, want)


# (bits, cluster, clusters): 2**16 int32 bins need two blocks at least
GRIDS = [(bits, cluster, clusters) for bits in (8, 15, 16)
         for cluster, clusters in ((1, 1), (1, 132), (2, 3), (2, 66), (4, 8),
                                   (4, 33), (8, 5), (8, 16), (8, 1))
         if (bits, cluster) != (16, 1)]


@pytest.mark.parametrize("bits,cluster,clusters", GRIDS)
def test_histogram_kernel_grids(cuda, bits, cluster, clusters):
    """Grids other than the plan's: every cluster size, one cluster (a
    plain flush) and several (atomic), into a pre-filled out."""
    rng = np.random.default_rng(clusters)
    n = 400_003
    idx = torch.from_numpy(rng.integers(0, 1 << bits, n)).to(cuda)
    w = torch.from_numpy(rng.integers(-2, 3, n).astype(np.int8)).to(cuda)
    chunk = -(-n // clusters // hk.LANES) * hk.LANES
    grid = hk.Plan(cluster, -(-n // chunk), chunk,
                   (1 << bits) // cluster * 4)
    out = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, 1 << bits)).to(
        cuda)
    got, want = _histogram_both(idx, w, bits, out=out, grid=grid)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,B", [(21, 2048), (21, 8192), (55, 2048)])
def test_hll_histogram_kernel_card_batch(cuda, k, B):
    """The `card` batch shape (2048 reads at L = 160), and the main
    batch, into a pre-filled histogram that is accumulated into."""
    keys, counts = _k1_stream(cuda, B, B, 160, k)
    rng = np.random.default_rng(k)
    out = torch.from_numpy(rng.integers(0, 1 << 40, 1 << 15)).to(cuda)
    got = hk.hll_class_histogram(keys, counts, k=k, b=10, out=out.clone())
    want = hk.hll_class_histogram_ref(keys, counts, k=k, b=10,
                                      out=out.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got - out).sum()) == int(counts.sum())


def test_compact_dense_and_card_cuda_equal_cpu(cuda, tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=2,
                                       error_rate=0.01))
    kw = dict(canonical=True, batch_reads=64, max_read_len=96)
    for extra in (dict(k=21, compact=True), dict(k=8, mode="dense"),
                  dict(k=12, mode="dense")):
        want = kmer_tpu_torch.count_fasta(str(path), device="cpu", **kw,
                                          **extra)
        ck.launches = hk.launches = 0
        got = kmer_tpu_torch.count_fasta(str(path), device="cuda", **kw,
                                         **extra)
        assert got == want
        batches = -(-300 * 2 // 64)
        assert ck.launches == (batches if extra.get("compact") else 0)
        assert hk.launches == (batches if extra["k"] <= 8 else 0)
    cfg = kmer_tpu_torch.KmerConfig(k=21, **kw)
    assert (kmer_tpu_torch.estimate_distinct_multi_k(str(path), [11, 21], cfg,
                                                     device="cuda")
            == kmer_tpu_torch.estimate_distinct_multi_k(str(path), [11, 21],
                                                        cfg, device="cpu"))
    gcfg = kmer_tpu_torch.KmerConfig(gapped=True, batch_reads=16,
                                     max_read_len=512, compact=True)
    rpath = tmp_path / "r.fasta"
    rpath.write_text(reference_style_fasta(n_records=40, seed=5))
    assert (kmer_tpu_torch.count_fasta(str(rpath), gcfg, device="cuda")
            == kmer_tpu_torch.count_fasta(str(rpath), gcfg, device="cpu"))


def _sort_both(words, **kw):
    """K6 (in place, on copies) and the plain version on the same rows;
    asserts they agree bit for bit and returns the launches made."""
    before = sk.launches
    got = sk.sort_words([w.clone() for w in words], **kw)
    want = sk.sort_words_ref(words, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return sk.launches - before


@pytest.mark.parametrize("W,N,hi", [
    (1, 1, 10), (1, 4096, 1 << 62), (2, 4097, 50), (2, 1_000_003, 1 << 42),
    (3, 12_345, 7), (4, 70_000, 3), (4, 8192, 1 << 62), (2, 300_000, 1)])
def test_sort_kernel_equals_plain(cuda, W, N, hi):
    rng = np.random.default_rng(W * 1000 + N)
    words = [torch.from_numpy(rng.integers(0, hi, N)).to(cuda)
             for _ in range(W)]
    sent = torch.from_numpy(rng.random(N) < 0.2).to(cuda)
    for w in words:
        w[sent] = sk.SENTINEL
    assert _sort_both(words) == 1


def test_sort_kernel_edges(cuda):
    n = 5000
    cases = [[torch.full((n,), sk.SENTINEL, device=cuda)] * 2,   # sentinels
             [torch.full((n,), 7, device=cuda)] * 3,             # all equal
             [torch.arange(n, device=cuda)],                     # presorted
             [torch.arange(n, 0, -1, device=cuda)] * 4]          # reversed
    for words in cases:
        assert _sort_both([w.clone() for w in words]) == 1
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = sk.launches
    assert sk.sort_words([empty])[0].numel() == 0
    assert sk.launches == before


def _keyed(cuda, seed, W, N, bits, dead=0.15):
    """W planes on the card: len(bits) key words (few distinct values,
    some wide ones, a share of all-sentinel rows; at bits 64 negatives,
    INT64_MIN and a real INT64_MAX), then payload words of distinct
    values, which show the order within equal keys."""
    rng = np.random.default_rng(seed)
    keys = []
    for b in bits:
        if b == 64:
            pool = np.array([np.iinfo(np.int64).min, -(1 << 40), -1, 0, 9,
                             1 << 62, sk.SENTINEL])
            keys.append(pool[rng.integers(0, len(pool), N)])
            continue
        k = rng.integers(0, min(1 << b, 6), N)
        wide = rng.random(N) < 0.5
        k[wide] = rng.integers(0, 1 << b, int(wide.sum()))
        keys.append(k)
    gone = rng.random(N) < dead
    for k, b in zip(keys, bits):
        if b < 64:
            k[gone] = sk.SENTINEL
    payload = [rng.permutation(N).astype(np.int64) - N // 2
               for _ in range(W - len(bits))]
    return [torch.from_numpy(p).to(cuda) for p in keys + payload]


@pytest.mark.parametrize("W,N,bits", [
    (1, 1, (42,)),                              # n = 1
    (2, sk.TILE_ROWS + 1, (42,)),               # one past a tile
    (2, 100_000, (16,)),                        # three passes: the copy back
    (2, 25_165_824, (42,)),                     # the k = 21 merge's rows
    (3, 50_001, (62, 48)),                      # a k = 55 merge
    (3, 20_000, (62, 64)),                      # k = 63: lo any int64
    (3, 77_777, (54, 54, 31)),                  # parity with counts
    (1, 4097, (0,)), (2, 9000, (64,)),
    *[(W, 30_001, (40, 64, 7, 20)[:K]) for W in (1, 2, 3, 4)
      for K in range(1, W + 1)]])
def test_sort_kernel_keys_and_bits_equal_plain(cuda, W, N, bits):
    """num_keys < W (payload order within equal keys included) and trimmed
    digits: K6 equals the plain version bit for bit."""
    words = _keyed(cuda, W * 100 + len(bits) + N, W, N, bits)
    assert _sort_both(words, num_keys=len(bits), bits=bits) == 1


@pytest.mark.parametrize("bits", [(42,), (64,)])
def test_sort_kernel_all_sentinel_keys(cuda, bits):
    n = 3 * sk.TILE_ROWS + 5
    key = torch.full((n,), sk.SENTINEL, device=cuda)
    payload = torch.arange(n, 0, -1, device=cuda)
    assert _sort_both([key, payload], num_keys=1, bits=bits) == 1
    got = sk.sort_words([key.clone(), payload.clone()], num_keys=1,
                        bits=bits)
    assert torch.equal(got[1], payload)            # stable: order kept


def _msd_case(cuda, case):
    """(planes, num_keys, bits) of the distributions K6's MSD levels must
    survive, a permutation as payload so that order within equal keys
    shows (chip_smoke.py phase 13 runs the same)."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    n = 3_000_000

    def rand(hi, rows=n):
        return torch.randint(0, hi, (rows,), generator=g, device=cuda)

    def perm(rows=n):
        return torch.randperm(rows, generator=g, device=cuda)
    if case == "one_key_repeated":
        key = rand(1 << 42)
        key[torch.rand(n, generator=g, device=cuda) < 0.4] = 123_456_789
        return [key, perm()], 1, (42,)
    if case == "one_top_bucket":
        return [rand(1 << 20), perm()], 1, (42,)
    if case in ("presorted", "reversed"):
        key = torch.sort(rand(1 << 42)).values
        return [key if case == "presorted" else key.flip(0).contiguous(),
                perm()], 1, (42,)
    if case == "devmerge_half_sentinel":
        state = torch.unique(rand(1 << 42, n // 4))
        batch = rand(1 << 42, n - n // 2)
        batch[torch.rand(batch.numel(), generator=g, device=cuda)
              < 0.2] = sk.SENTINEL
        key = torch.cat([state, torch.full((n // 2 - state.numel(),),
                                           sk.SENTINEL, device=cuda), batch])
        return [key, rand(50)], 1, (42,)
    if case == "planes6_keys5":
        bits = (62, 62, 62, 62, 12)
        keys = [rand(8 if q < 3 else 1 << b) for q, b in enumerate(bits)]
        dead = torch.rand(n, generator=g, device=cuda) < 0.2
        return [torch.where(dead, sk.SENTINEL, k) for k in keys] + [perm()], \
            5, bits
    if case == "near_duplicates":
        hi, lo = rand(1 << 62), rand(1 << 48)
        twin = torch.rand(n, generator=g, device=cuda) < 0.2
        hi[1:] = torch.where(twin[1:], hi[:-1], hi[1:])
        dup = torch.rand(n, generator=g, device=cuda) < 0.05
        hi, lo = torch.where(dup, hi[0], hi), torch.where(dup, lo[0], lo)
        return [hi, lo, perm()], 2, (62, 48)
    if case == "fix_fallback":
        hi, lo, count = rand(1 << 54), rand(1 << 54), rand(1000) + 1
        hot = perm()[:6000]
        hi[hot], lo[hot] = 12345, 678
        return [hi, lo, count], 3, (54, 54, 31)
    assert case == "planes240"
    rows = 50_000
    return ([rand(5, rows), rand(3, rows), rand(1 << 16, rows)]
            + [perm(rows) for _ in range(237)], 3, (3, 2, 16))


@pytest.mark.parametrize("case", ["one_key_repeated", "one_top_bucket",
                                  "presorted", "reversed",
                                  "devmerge_half_sentinel", "planes6_keys5",
                                  "planes240", "near_duplicates",
                                  "fix_fallback"])
def test_sort_kernel_msd_adversarial(cuda, case):
    """K6's MSD levels on a key repeated over 1.2 M of 3 M rows, every row
    in one top-level bucket, presorted and reversed input, the device
    merge with half the rows sentinel, 6 planes of 5 keys and 240 planes;
    its local sort's run fix-up on near-duplicate k = 55 pairs and its
    fallback on 6000 rows of one (hi, lo) with varying counts: bit for
    bit with the plain version, payload order included."""
    words, num_keys, bits = _msd_case(cuda, case)
    assert _sort_both(words, num_keys=num_keys, bits=bits) == 1


def test_sort_kernel_launch_info(cuda):
    """launch_info: the plan's levels and launches, grids within the
    capacities, and the resident blocks the grids are sized for (three
    scatter blocks an SM, two local ones)."""
    info = sk.launch_info(25_165_824, 2, 1, (42,))
    assert info["body"] == "msd"
    assert (info["levels"], info["launches"]) == (6, 24)
    assert 1 <= info["scatter_grid"] <= info["run_grid"] <= info["cap_runs"]
    assert 1 <= info["local_grid"] <= info["cap_tiles"]
    assert info["scatter_blocks_per_sm"] >= 3
    assert info["local_blocks_per_sm"] >= 2
    assert sk.launch_info(1000, 5, 4, (62, 62, 62, 16))["param_planes"] == 16


def test_devmerge_count_cuda_equals_cpu(cuda, tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=3,
                                       error_rate=0.01))
    kw = dict(k=21, canonical=True, batch_reads=64, max_read_len=96)
    want = kmer_tpu_torch.count_fasta(str(path), device="cpu", **kw)
    sk.launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), device="cuda",
                                     device_merge="on", **kw)
    assert got == want and sk.launches > 0
    rpath = tmp_path / "r.fasta"
    rpath.write_text(reference_style_fasta(n_records=40, seed=5))
    gcfg = kmer_tpu_torch.KmerConfig(gapped=True, batch_reads=16,
                                     max_read_len=512)
    assert (kmer_tpu_torch.count_fasta(str(rpath),
                                       gcfg.replace(device_merge="on"),
                                       device="cuda")
            == kmer_tpu_torch.count_fasta(str(rpath), gcfg, device="cpu"))


@pytest.mark.parametrize("B,L,k,canon,amb,packed", [
    (8192, 160, 21, True, False, True),      # the main path's shape
    (300, 78, 1, False, True, False), (300, 78, 16, True, False, True),
    (300, 78, 17, False, True, False), (999, 77, 31, True, True, False),
    (37, 40, 31, False, False, True),
    # two-word keys, rows of 176 and 77 bases
    (300, 176, 32, True, False, True), (301, 77, 32, False, True, False),
    (300, 176, 55, True, True, False), (8192, 160, 55, True, False, True),
    (303, 77, 55, False, False, True), (300, 176, 63, False, True, False),
    (299, 77, 63, True, False, True)])
def test_extract_kernel_equals_plain(cuda, B, L, k, canon, amb, packed):
    rng = np.random.default_rng(B + k)
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    host = [torch.from_numpy(pack_batch_codes(codes).view(np.int32)
                             if packed else codes),
            torch.from_numpy(lengths), torch.from_numpy(limits)]
    kw = dict(canonical=canon, mask_ambiguous=amb,
              packed_width=L if packed else 0)
    want = ek.extract_keys(*host, k, **kw)
    before = ek.launches
    got = ek.extract_keys(*(t.to(cuda) for t in host), k, **kw)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    assert _same_keys(got, want)


def _planted(n, seed):
    """16 packed rows, row a holding one key of n bases at window 16 + a
    (every alignment in a packed word), and the key's value and reverse
    complement's."""
    L = 48 + n + 16
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 4, n, dtype=np.uint8)
    codes = rng.integers(0, 4, (16, L), dtype=np.uint8)
    for a in range(16):
        codes[a, 16 + a:16 + a + n] = key
    value = int("".join(map(str, key)), 4)
    rc = int("".join(str(3 - c) for c in key[::-1]), 4)
    return codes, value, rc


def _value(keys, n, row, o, position_major=False):
    """The key value of one lane of an int64 plane, or of a (hi, lo) pair
    with lo's flip undone."""
    at = (o, row) if position_major else (row, o)
    if n <= 31:
        return int(keys[at])
    r = 2 * (n - 31)
    low = int(keys[1][at]) & (2 ** 64 - 1)
    return int(keys[0][at]) << r | (low ^ (1 << 63) if r == 64 else low)


@pytest.mark.parametrize("n", [1, 21, 31, 32, 55, 63])
@pytest.mark.parametrize("canon", [False, True])
def test_cut_kernels_planted_alignments(cuda, n, canon):
    """K1 and K7 cut a planted key back at each of the 16 alignments of a
    packed word, and equal their plain versions on the whole batch."""
    codes, value, rc = _planted(n, n + canon)
    L = codes.shape[1]
    want = min(value, rc) if canon else value
    lens = torch.full((16,), L, dtype=torch.int32)
    host = [torch.from_numpy(pack_batch_codes(codes).view(np.int32)), lens,
            lens]
    kw = dict(canonical=canon, packed_width=L)
    dev = [t.to(cuda) for t in host]
    k7 = ek.extract_keys(*dev, n, **kw)
    k1, counts = fe.fused_extract_count(*dev, n, **kw)
    torch.cuda.synchronize()
    k7 = tuple(p.cpu() for p in k7) if n > 31 else k7.cpu()
    k1 = tuple(p.cpu() for p in k1) if n > 31 else k1.cpu()
    for a in range(16):
        assert _value(k7, n, a, 16 + a) == want
        assert _value(k1, n, a, 16 + a, position_major=True) == want
    assert _same_keys(k7, ek.extract_keys(*host, n, **kw))
    want1, want_counts = fe.fused_extract_count(*host, n, **kw)
    assert _same_keys(k1, want1) and torch.equal(counts.cpu(), want_counts)


def _launch_strided(which, store, packed, L, k, canon, amb, lengths, limits,
                    seg=2):
    """K1 or K7 through its C entry on rows `store.shape[1]` words (or
    codes) apart, wider than the row: the wrappers take only contiguous
    rows of their width."""
    B = store.shape[0]
    P = L - k + 1
    P_pad = -(-P // seg) * seg
    shape = (P_pad, B) if which == "k1" else (B, P)
    hi = torch.empty(shape, dtype=torch.int64, device=store.device)
    lo = torch.empty_like(hi) if k > 31 else None
    stream = torch.cuda.current_stream().cuda_stream
    lo_ptr = None if lo is None else lo.data_ptr()
    if which == "k1":
        counts = torch.empty(shape, dtype=torch.int8, device=store.device)
        rc = fe.load().fused_extract_count_launch(
            store.data_ptr(), int(packed), store.shape[1], lengths.data_ptr(),
            limits.data_ptr(), hi.data_ptr(), lo_ptr, counts.data_ptr(), B, L,
            k, k, P, P_pad, int(canon), int(amb), seg, None, None, stream)
    else:
        rc = ek.load().extract_launch(
            store.data_ptr(), int(packed), store.shape[1], lengths.data_ptr(),
            limits.data_ptr(), hi.data_ptr(), lo_ptr, B, L, k, k, int(canon),
            int(amb), None, None, stream)
    assert rc == 0
    torch.cuda.synchronize()
    return (hi.cpu(), lo.cpu()) if lo is not None else hi.cpu()


@pytest.mark.parametrize("k", [21, 32, 63])
@pytest.mark.parametrize("packed", [True, False])
def test_cut_kernels_wide_row_stride(cuda, k, packed):
    """Rows further apart than their width (row_stride > ceil(L / 16)
    words, or > L codes), with noise past each row and, packed, in the
    last word's bits past L: the keys equal the plain version's of the
    rows alone."""
    rng = np.random.default_rng(k + packed)
    B, L = 200, 77
    codes = rng.integers(0, 5, (B, L), dtype=np.uint8)
    if packed:
        codes &= 3
        W = (L + 15) // 16
        store = rng.integers(0, 1 << 32, (B, W + 3), dtype=np.uint64
                             ).astype(np.uint32)
        store[:, :W] = pack_batch_codes(codes)
        store[:, W - 1] |= rng.integers(0, 1 << 6, B, dtype=np.uint32)
        store = store.view(np.int32)
    else:
        store = rng.integers(0, 256, (B, L + 5), dtype=np.uint8)
        store[:, :L] = codes
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    args = [torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(limits)]
    dev = [torch.from_numpy(np.ascontiguousarray(store)).to(cuda)] + [
        t.to(cuda) for t in args[1:]]
    amb = not packed
    kw = dict(canonical=True, mask_ambiguous=amb)
    got7 = _launch_strided("k7", dev[0], packed, L, k, True, amb, *dev[1:])
    assert _same_keys(got7, ek.extract_keys(*args, k, **kw))
    got1 = _launch_strided("k1", dev[0], packed, L, k, True, amb, *dev[1:])
    assert _same_keys(got1, fe.fused_extract_count(*args, k, **kw)[0])


@pytest.mark.parametrize("k", [21, 55])
def test_cut_kernels_u8_low_bits(cuda, k):
    """Without the ambiguity mask a u8 code >= 4 reads as its low two bits
    (4..7 and 255 here), in K1 and K7 alike."""
    rng = np.random.default_rng(k)
    B, L = 257, 160
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    odd = rng.random((B, L)) < 0.05
    codes[odd] = rng.choice(np.array([4, 5, 6, 7, 255], np.uint8),
                            int(odd.sum()))
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    host = [torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(lengths)]
    dev = [t.to(cuda) for t in host]
    for canon in (False, True):
        assert _same_keys(ek.extract_keys(*dev, k, canonical=canon),
                          ek.extract_keys(*host, k, canonical=canon))
        got, counts = fe.fused_extract_count(*dev, k, canonical=canon)
        want, want_counts = fe.fused_extract_count(*host, k, canonical=canon)
        assert _same_keys(got, want)
        assert torch.equal(counts.cpu(), want_counts)


def test_cut_kernels_fill_the_card(cuda):
    """At the main path's batch (8192 rows of 160 bases, k = 21, seg 2) K1
    runs in one wave and K7 launches at least as many threads as the card
    has slots, both with no spills."""
    props = torch.cuda.get_device_properties(cuda)
    sms = props.multi_processor_count
    k1 = fe.launch_info(8192, 160, 21, canonical=True)
    k7 = ek.launch_info(8192, 160, 21, canonical=True)
    assert k1["blocks"] <= k1["blocks_per_sm"] * sms
    assert (k7["threads"] * k7["blocks"]
            >= sms * props.max_threads_per_multi_processor)
    assert k1["spill_bytes"] == k7["spill_bytes"] == 0


def _rows(cuda, seed, shape, W, hi=5, dead=0.2, sort=False):
    """W int64 planes of `shape` with many duplicates and dead rows; with
    sort=True each row group-sorted (K2a's input)."""
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.integers(0, hi, shape)) for _ in range(W)]
    gone = torch.from_numpy(rng.random(shape) < dead)
    planes = [torch.where(gone, sk.SENTINEL, p) for p in planes]
    if sort:
        planes = gk.sort_groups(planes)
    return [p.to(cuda) for p in planes]


@pytest.mark.parametrize("G,m,W", [(4480, 256, 1), (64, 128, 2), (5, 300, 4),
                                   (1, 2, 1), (3, 1, 2), (2, 1000, 3),
                                   (1, 4096, 1)])
def test_run_lengths_kernel_equals_plain(cuda, G, m, W):
    planes = _rows(cuda, G * m + W, (G, m), W, sort=True)
    before = gk.run_lengths_launches
    got = gk.run_lengths_grouped(planes)
    want = gk.run_lengths_grouped_ref(planes)
    torch.cuda.synchronize()
    assert gk.run_lengths_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("G,m,W", [(4480, 256, 1), (64, 128, 2), (7, 2, 4),
                                   (1, 16384, 1), (3, 4096, 4), (2, 8192, 3),
                                   (1, 1, 1)])
def test_grouped_kernels_equal_plain(cuda, G, m, W):
    """K2b on (G, m) rows and K2c on the (m, G) columns, bit for bit."""
    for fn, ref, counter, shape in (
            (gk.grouped_count, gk.grouped_count_ref, "grouped_launches",
             (G, m)),
            (gk.grouped_count_strided, gk.grouped_count_strided_ref,
             "strided_launches", (m, G))):
        planes = _rows(cuda, G * m + W, shape, W)
        before = getattr(gk, counter)
        got_s, got_c = fn(planes)
        want_s, want_c = ref(planes)
        torch.cuda.synchronize()
        assert getattr(gk, counter) == before + 1
        assert torch.equal(got_c, want_c)
        for g, w in zip(got_s, want_s):
            assert torch.equal(g, w)


def _sort_check(fn, ref, counter, planes):
    """One launch of K2b or K2c on `planes`, bit for bit against the plain
    version on the same tensors."""
    before = getattr(gk, counter)
    got_s, got_c = fn(planes)
    want_s, want_c = ref(planes)
    torch.cuda.synchronize()
    assert getattr(gk, counter) == before + 1
    assert torch.equal(got_c, want_c)
    for g, w in zip(got_s, want_s):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_grouped_column_body(cuda, m, W):
    """K2c's column body (a thread per strided column, two where G is even
    and they fit): G = 1, odd and even; m = 1 also through K2b."""
    for G in (1, 129, 2 * 4096 + 2):
        planes = _rows(cuda, G + m + W, (m, G), W, hi=4)
        info = gk.launch_info(G, m, W, strided=True)
        assert info["body"].startswith("column") == (m * W <= 64)
        _sort_check(gk.grouped_count_strided, gk.grouped_count_strided_ref,
                    "strided_launches", planes)
        if m == 1:
            _sort_check(gk.grouped_count, gk.grouped_count_ref,
                        "grouped_launches", [p.view(G, 1) for p in planes])


@pytest.mark.parametrize("m", [2, 16, 32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_grouped_warp_body(cuda, m, W):
    """K2b's warp body (a warp per span of 32 R rows, R = max(2, m / 32)):
    G with a partial last span, and G = 1."""
    R = max(2, m // 32)
    for G in (1, 3 * 32 * R // m * 4 + 1 if m < 32 * R else 37):
        planes = _rows(cuda, G * m + W, (G, m), W, hi=6)
        info = gk.launch_info(G, m, W)
        assert (info["body"] == "warp") == (R * W <= 32)
        _sort_check(gk.grouped_count, gk.grouped_count_ref,
                    "grouped_launches", planes)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("strided", [False, True])
def test_grouped_block_body(cuda, W, strided):
    """The block body's groups of 1024 rows up to max_group_rows(W), in
    both layouts."""
    m = 1024
    while m <= gk.max_group_rows(W):
        G = 3
        planes = _rows(cuda, m + W, (m, G) if strided else (G, m), W,
                       hi=50)
        if strided or m * W > 1024:
            assert gk.launch_info(G, m, W, strided=strided)["body"] == \
                "block"
        fn, ref, counter = ((gk.grouped_count_strided,
                             gk.grouped_count_strided_ref, "strided_launches")
                            if strided else (gk.grouped_count,
                                             gk.grouped_count_ref,
                                             "grouped_launches"))
        _sort_check(fn, ref, counter, planes)
        m *= 2


@pytest.mark.parametrize("m,W,strided", [(16, 1, True), (8, 2, True),
                                         (32, 1, True), (64, 2, False),
                                         (256, 1, False), (2, 3, False),
                                         (2048, 1, False), (128, 2, True)])
def test_grouped_kernels_unaligned(cuda, m, W, strided):
    """Planes that start 8 bytes past a 16-byte boundary (slices of a
    larger tensor) take the scalar accesses."""
    G = 130
    base = _rows(cuda, m + G, (G * m + 1,), W)
    planes = [p[1:].view((m, G) if strided else (G, m)) for p in base]
    assert all(p.data_ptr() % 16 == 8 for p in planes)
    fn, ref, counter = ((gk.grouped_count_strided,
                         gk.grouped_count_strided_ref, "strided_launches")
                        if strided else (gk.grouped_count,
                                         gk.grouped_count_ref,
                                         "grouped_launches"))
    _sort_check(fn, ref, counter, planes)


def test_grouped_kernel_edges(cuda):
    """All sentinels, one run filling a group, the strided route at
    m = 16 over K7-sized input."""
    dead = torch.full((8, 256), sk.SENTINEL, device=cuda)
    assert int(gk.run_lengths_grouped([dead]).abs().sum()) == 0
    assert int(gk.grouped_count([dead, dead])[1].abs().sum()) == 0
    one = torch.full((4, 4096), 3, dtype=torch.int64, device=cuda)
    for counts in (gk.run_lengths_grouped([one]), gk.grouped_count([one])[1]):
        assert counts[:, 0].tolist() == [4096] * 4
        assert int(counts[:, 1:].abs().sum()) == 0
    planes = _rows(cuda, 9, (16, 71680), 1, hi=1 << 40, dead=0.1)
    got = gk.grouped_count_strided(planes)
    want = gk.grouped_count_strided_ref(planes)
    assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[1],
                                                              want[1])


@pytest.mark.parametrize("n", [1_146_880, 4097, 20])
def test_compact_kernel_int32_counts(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 1 << 42, n)).to(cuda)
    counts = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(
        cuda)
    launched, t = _compact_both((keys,), counts)
    assert launched == 1 and t == int((counts > 0).sum())


def _k4_edge(dev, name):
    """(planes, counts, kwargs) of a case only K4's look-back can get
    wrong: lanes around a tile, live lanes over many tiles, in the last
    tile only or in every other tile, an int32 tail no multiple of 4."""
    T = ck.TILE
    rng = np.random.default_rng(len(name))

    def lanes(n, share, dtype=np.int8):
        c = ((rng.random(n) < share) * rng.integers(1, 100, n)).astype(dtype)
        return ([torch.from_numpy(rng.integers(0, 1 << 62, n)).to(dev)],
                torch.from_numpy(c).to(dev), {})

    sizes = {"one_lane": (1, 1.0), "tile_minus_1": (T - 1, 0.5),
             "tile": (T, 0.5), "tile_plus_1": (T + 1, 0.5),
             "all_live_40_tiles": (40 * T, 1.0)}
    if name in sizes:
        return lanes(*sizes[name])
    if name == "all_live_40_tiles_int32":
        return lanes(40 * T, 1.0, np.int32)
    if name == "int32_tail":
        return lanes(12345, 0.6, np.int32)
    if name == "one_live_in_last_tile":
        planes, counts, kw = lanes(10 * T + 37, 0.0)
        counts[-5] = 3
        return planes, counts, kw
    if name == "every_other_tile":
        planes, counts, kw = lanes(21 * T, 0.7)
        counts.view(21, T)[1::2] = 0
        return planes, counts, kw
    hi = torch.from_numpy(rng.integers(0, 1 << 62, 5 * T + 3)).to(dev)
    lo = torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, 5 * T + 3,
                                       dtype=np.int64)).to(dev)
    _, counts, _ = lanes(5 * T + 3, 0.8)
    if name == "pair_one_word":
        return ([hi & ((1 << 20) - 1), lo & ((1 << 30) - 1)], counts,
                dict(r_len=15, n_bases=25))
    return [hi, lo], counts, dict(r_len=32, n_bases=63)


@pytest.mark.parametrize("name", ["one_lane", "tile_minus_1", "tile",
                                  "tile_plus_1", "all_live_40_tiles",
                                  "all_live_40_tiles_int32",
                                  "one_live_in_last_tile",
                                  "every_other_tile", "int32_tail",
                                  "pair_one_word", "pair_r32"])
def test_compact_kernel_look_back_edges(cuda, name):
    planes, counts, kw = _k4_edge(cuda, name)
    launched, t = _compact_both(planes, counts, **kw)
    assert launched == 1 and t == int((counts > 0).sum())


def test_compact_kernel_back_to_back(cuda):
    """Streams of lanes compacted one after another with no sync between,
    on the current CUDA stream and on a second one: a status word or tile
    counter left by a call would corrupt the next."""
    names = ["all_live_40_tiles", "tile_plus_1", "every_other_tile",
             "one_lane", "int32_tail", "pair_r32", "all_live_40_tiles"]
    cases = [_k4_edge(cuda, name) for name in names]
    side = torch.cuda.Stream()
    outs = []
    for i, (planes, counts, kw) in enumerate(cases):
        with torch.cuda.stream(side if i % 3 == 2 else
                               torch.cuda.current_stream()):
            outs.append(ck.compact(planes, counts, **kw))
    torch.cuda.synchronize()
    for (planes, counts, kw), got in zip(cases, outs):
        want = ck.compact_ref(planes, counts, **kw)
        t = int(want[2][0])
        assert int(got[2][0]) == t
        assert torch.equal(got[0][:t], want[0][:t])
        assert torch.equal(got[1][:t], want[1][:t])


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 3, 33, 128, 1000, 4096])
def test_run_lengths_kernel_any_m(cuda, m, W):
    planes = _rows(cuda, m * 4 + W, (max(1, 100_000 // (m * W)), m), W, hi=3,
                   sort=True)
    assert torch.equal(gk.run_lengths_grouped(planes),
                       gk.run_lengths_grouped_ref(planes))


@pytest.mark.parametrize("name", ["fill_group", "over_tile_end",
                                  "sentinel_groups", "unaligned_view"])
def test_run_lengths_kernel_flat_edges(cuda, name):
    """A run filling its group, a run over the end of a 1024-row tile,
    groups of sentinels only, planes that are not 16-byte aligned."""
    if name == "fill_group":
        planes = [torch.full((6, 4096), 5, dtype=torch.int64, device=cuda)]
    elif name == "over_tile_end":
        x = torch.full((6, 4096), 9, dtype=torch.int64, device=cuda)
        x[:, 1000:3100] = 11
        x[:, 3100:] = sk.SENTINEL
        planes = [x, x.clone()]
    elif name == "sentinel_groups":
        planes = _rows(cuda, 3, (100, 1000), 3, dead=1.0, sort=True)
    else:
        rows = _rows(cuda, 4, (700, 128), 2, hi=3, sort=True)
        planes = []
        for r in rows:
            flat = torch.empty(1 + r.numel(), dtype=torch.int64, device=cuda)
            flat[1:] = r.reshape(-1)
            planes.append(flat[1:].view(700, 128))
    got = gk.run_lengths_grouped(planes)
    assert torch.equal(got, gk.run_lengths_grouped_ref(planes))
    if name == "fill_group":
        assert got[:, 0].tolist() == [4096] * 6 and not got[:, 1:].any()


@pytest.mark.parametrize("env,extra", [
    (dict(KMER_TPU_STEP="legacy"), {}),
    (dict(KMER_TPU_STEP="legacy", KMER_TPU_GROUPED="pallas"), {}),
    (dict(KMER_TPU_STEP="t"), {}),
    ({}, dict(sort_group_keys=0)),
    (dict(KMER_TPU_STEP="legacy"), dict(compact=True)),
    (dict(KMER_TPU_STEP="legacy"), dict(device_merge="on"))])
def test_unfused_count_cuda_equals_cpu(cuda, tmp_path, monkeypatch, env,
                                       extra):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=6,
                                       error_rate=0.01))
    kw = dict(k=21, canonical=True, batch_reads=64, max_read_len=96, **extra)
    want = kmer_tpu_torch.count_fasta(str(path), device="cpu", **kw)
    ek.launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), device="cuda", **kw)
    assert got == want and got.total == 300 * 130
    assert ek.launches == -(-300 * 2 // 64)


# chip_smoke.py's spaced masks: span 31 with 24 selected (one word), span 55
# with 42 selected (a pair)
MASK24 = "1110111011101110111011101110111"
MASK42 = "1110111011101110111011101110111011101110111011101110111"
# (k, mask, canonical, ambiguous, seg, packed)
WIDE_CASES = [(32, None, True, False, 2, True),
              (45, None, False, True, 4, False),
              (48, None, True, True, 2, False),
              (55, None, True, False, 2, True),
              (63, None, False, False, 16, True),
              (63, None, True, True, 8, False),
              (24, MASK24, True, True, 2, False),
              (42, MASK42, True, False, 2, True),
              (42, MASK42, False, True, 4, False),
              (5, "1101011", False, False, 2, True),
              # the rolled span's edges: spans of exactly 32 and 64, a
              # 32-base key in a 32-base span, lo a 32-base run (flipped
              # top bit), single-base runs, no palindrome; then a span
              # over 64 (the gathered window)
              (8, "1111" + "0" * 24 + "1111", True, True, 2, False),
              (8, "1111" + "0" * 24 + "1111", False, False, 4, True),
              (32, "1" * 32, True, False, 2, True),
              (40, "1" * 20 + "0" * 24 + "1" * 20, True, True, 8, False),
              (40, "1" * 20 + "0" * 24 + "1" * 20, False, False, 2, True),
              (63, "1" * 31 + "0" + "1" * 32, False, True, 2, False),
              (63, "1" * 31 + "0" + "1" * 32, False, False, 16, True),
              (32, "10" * 31 + "1", True, False, 2, True),
              (32, "10" * 31 + "1", False, True, 4, False),
              (7, "110100101011", False, True, 2, False),
              (20, "1" * 10 + "0" * 80 + "1" * 10, True, True, 2, False),
              (20, "1" * 10 + "0" * 80 + "1" * 10, False, False, 2, True)]


def _wide_batch(seed, B, L, amb, packed):
    """Random rows with poly-T rows, short lengths and limits; u8 rows
    carry 2% ambiguous codes when amb."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if amb:
        codes[rng.random((B, L)) < 0.02] = 4
    codes[0] = 3
    codes[1, 40:] = 3
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[:2] = limits[:2] = L
    c = pack_batch_codes(codes).view(np.int32) if packed else codes
    return [torch.from_numpy(np.ascontiguousarray(c)),
            torch.from_numpy(lengths), torch.from_numpy(limits)]


def _positions(mask):
    return tuple(i for i, c in enumerate(mask) if c == "1") if mask else None


def _same_keys(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g.cpu(), w.cpu())
                                         for g, w in zip(got, want))


@pytest.mark.parametrize("k,mask,canon,amb,seg,packed", WIDE_CASES)
def test_wide_kernel_equals_plain(cuda, k, mask, canon, amb, seg, packed):
    """K1 on keys of 32 to 63 bases and on spaced seeds, bit for bit."""
    B, L = 300, 110
    host = _wide_batch(k + seg, B, L, amb, packed)
    kw = dict(canonical=canon, mask_ambiguous=amb, seg=seg,
              packed_width=L if packed else 0, positions=_positions(mask))
    want_keys, want_counts = fe.fused_extract_count(*host, k, **kw)
    before = fe.launches
    keys, counts = fe.fused_extract_count(*(t.to(cuda) for t in host), k,
                                          **kw)
    torch.cuda.synchronize()
    assert fe.launches == before + 1
    assert _same_keys(keys, want_keys)
    assert torch.equal(counts.cpu(), want_counts)
    assert int((want_counts > 0).sum()) > 0


@pytest.mark.parametrize("k,mask,canon,amb,seg,packed", WIDE_CASES)
def test_wide_extract_kernel_equals_plain(cuda, k, mask, canon, amb, seg,
                                          packed):
    """K7 on keys of 32 to 63 bases and on spaced seeds, bit for bit."""
    B, L = 300 + seg, 110
    host = _wide_batch(k + 2 * seg, B, L, amb, packed)
    kw = dict(canonical=canon, mask_ambiguous=amb,
              packed_width=L if packed else 0, positions=_positions(mask))
    want = ek.extract_keys(*host, k, **kw)
    before = ek.launches
    got = ek.extract_keys(*(t.to(cuda) for t in host), k, **kw)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    assert _same_keys(got, want)


@pytest.mark.parametrize("k", [33, 63])
def test_compact_kernel_pairs(cuda, k):
    """K4 on K1's (hi, lo) output; k = 63 takes lo's flip off."""
    keys, counts = _k1_stream(cuda, k, 999, 160, k)
    launched, t = _compact_both(keys, counts, r_len=k - 31, n_bases=k)
    assert launched == 1 and t == int((counts > 0).sum()) > 0


@pytest.mark.parametrize("kw,env", [
    (dict(k=45, canonical=True), {}), (dict(k=63), {}),
    (dict(k=45, canonical=True, compact=True), {}),
    (dict(k=63, canonical=True, device_merge="on"), {}),
    (dict(k=45), dict(KMER_TPU_STEP="legacy")),
    (dict(k=33, sort_group_keys=0), {}),
    (dict(seed_mask=MASK42, canonical=True), {}),
    (dict(seed_mask=MASK42, device_merge="on"), {}),
    (dict(seed_mask=MASK24, sort_group_keys=0), {}),
    (dict(seed_mask=MASK42, canonical=True), dict(KMER_TPU_STEP="legacy"))])
def test_wide_and_spaced_count_cuda_equal_cpu(cuda, tmp_path, monkeypatch,
                                              kw, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=7,
                                       error_rate=0.01))
    cfg = kmer_tpu_torch.KmerConfig(batch_reads=64, max_read_len=96, **kw)
    want = kmer_tpu_torch.count_fasta(str(path), cfg, device="cpu")
    fe.launches = ek.launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), cfg, device="cuda")
    span = cfg.window_span
    assert got == want and got.total == 300 * (150 - span + 1)
    # 150-base reads in 96-base rows overlapping by span - 1 bases
    rows = 1 + -(-(150 - 96) // (96 - (span - 1)))
    assert fe.launches + ek.launches == -(-300 * rows // 64)


def test_k63_sentinel_trap_cuda(cuda, tmp_path, monkeypatch):
    """A poly-T key and a key ending in 32 T's at k = 63 are counted on
    the card in every mode."""
    head = "ACGTTGCAACGTTGCAACGTTGCAACGTTGC"
    path = tmp_path / "t.fasta"
    path.write_text(f">a\n{'T' * 70}\n>b\n{head}{'T' * 32}\n")
    want = {"T" * 63: 8, head + "T" * 32: 1}
    for extra in (dict(), dict(compact=True), dict(device_merge="on"),
                  dict(sort_group_keys=0)):
        got = kmer_tpu_torch.count_fasta(str(path), k=63, device="cuda",
                                         **extra)
        assert got.to_dict() == want, extra
    monkeypatch.setenv("KMER_TPU_STEP", "legacy")
    assert kmer_tpu_torch.count_fasta(str(path), k=63,
                                      device="cuda").to_dict() == want


def test_wide_and_spaced_card_cuda_equal_cpu(cuda, tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=8))
    for kw in (dict(k=45, canonical=True), dict(seed_mask=MASK42)):
        cfg = kmer_tpu_torch.KmerConfig(batch_reads=64, max_read_len=96, **kw)
        assert (kmer_tpu_torch.estimate_distinct_multi_k(str(path), [45], cfg,
                                                         device="cuda")
                == kmer_tpu_torch.estimate_distinct_multi_k(
                    str(path), [45], cfg, device="cpu"))


@pytest.mark.parametrize("kw,rows", [
    (dict(k=21, canonical=True, device_merge="off"), None),
    (dict(k=21, canonical=True, device_merge="on"), "512"),
    (dict(k=45, canonical=True, device_merge="on"), None),
    (dict(gapped=True, l_len=12, r_len=13, c_min=30, c_max=40,
          device_merge="off"), None),
    (dict(gapped=True, l_len=12, r_len=13, c_min=30, c_max=40,
          device_merge="on"), "512")])
def test_streaming_cuda_equals_cpu(cuda, tmp_path, monkeypatch, kw, rows):
    """StreamingCounter on the card: the per-batch route (K1 or K3 a
    batch) and the device merge (K6; a fixed tiny capacity forces drains
    between commits), paused mid-pass-1 and resumed by a fresh counter,
    equals the CPU's uninterrupted run."""
    if rows:
        monkeypatch.setenv("KMER_TPU_DEVMERGE_ROWS", rows)
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=4,
                                       error_rate=0.01))
    cfg = kmer_tpu_torch.KmerConfig(batch_reads=32, max_read_len=96,
                                    partitions=5, ingest_chunk_bases=9000,
                                    **kw)
    want = kmer_tpu_torch.stream_count_fasta(
        str(path), cfg, spill_dir=str(tmp_path / "cpu"), device="cpu")
    spill = str(tmp_path / "cuda")
    sc = kmer_tpu_torch.StreamingCounter(str(path), cfg, spill,
                                         device="cuda")
    fe.launches = fg.launches = sk.launches = 0
    from kmer_tpu_torch.pipeline.count import count_batches, iter_chunks
    _, offsets = next(iter_chunks([str(path)], cfg))
    sc.run_pass1(max_batches=count_batches(offsets, cfg) + 1)
    assert sc.state["pass1_cursor"] > 0 and not sc.state["pass1_done"]
    sc = kmer_tpu_torch.StreamingCounter(str(path), cfg, spill,
                                         device="cuda")
    sc.run()
    batches = sc.state["pass1_next_batch"]
    assert sc.final_table() == want and want.total > 0
    assert (fg.launches if cfg.gapped else fe.launches) == batches
    assert (sk.launches > 0) == (kw["device_merge"] == "on")


@pytest.mark.parametrize("cmd", ["count", "histo"])
def test_two_pass_cli_cuda_equals_cpu(cuda, tmp_path, capsys, cmd):
    from kmer_tpu_torch.cli import main
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=5))
    args = [cmd, str(path), "-k", "21", "--canonical", "--batch-reads",
            "64", "--two-pass", "--partitions", "4"]
    outs = []
    for dev in ("cpu", "cuda"):
        assert main(args + ["--spill-dir", str(tmp_path / dev),
                            "--device", dev]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("\n") > 3


@pytest.mark.parametrize("two_pass", [False, True])
def test_cli_profile_dir_traces_k1(cuda, tmp_path, capsys, two_pass):
    """count --profile-dir on the card: a Chrome trace that names K1's
    kernel among its device events and the program's layers among its
    ranges (utils/stagetime), and the TSV of the untraced run."""
    import glob
    import json
    from kmer_tpu_torch.cli import main
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(3000, 150, genome_len=20000, seed=3))
    args = ["count", str(path), "-k", "21", "--canonical", "--device",
            "cuda"]
    if two_pass:
        args += ["--two-pass", "--partitions", "4", "--spill-dir"]
    assert main(args + ([str(tmp_path / "s1")] if two_pass else [])) == 0
    want = capsys.readouterr().out
    prof = tmp_path / "prof"
    assert main(args + ([str(tmp_path / "s2")] if two_pass else [])
                + ["--profile-dir", str(prof)]) == 0
    assert capsys.readouterr().out == want and want.count("\n") > 1000
    [trace] = glob.glob(str(prof / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("fused_cut_kernel" in name for name in kernels), kernels
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"stage::dispatch", "stage::dispatch.h2d", "stage::dispatch.step",
            "op::K1"} <= ranges, sorted(ranges)


def test_bgzf_counts_as_plain_text_cuda(cuda, tmp_path, monkeypatch):
    """A BGZF file the port writes counts on the card, its blocks inflated
    by several threads, to the table of its plain text."""
    from kmer_tpu_torch.io.bgzf import write_bgzf
    text = genome_reads_fasta(4000, 150, genome_len=30000, seed=8,
                              error_rate=0.01)
    plain, gz = tmp_path / "g.fasta", tmp_path / "g.fasta.gz"
    plain.write_text(text)
    write_bgzf(str(gz), text, block=8192)
    monkeypatch.setenv("KMER_TPU_PARSE_THREADS", "4")
    kw = dict(k=21, canonical=True, device_merge="on")
    fe.launches = 0
    got = kmer_tpu_torch.count_fasta(str(gz), **kw)
    assert fe.launches > 0
    want = kmer_tpu_torch.count_fasta(str(plain), **kw)
    assert got == want and got.total == 4000 * 130


def _mesh_corpus(tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(2000, 150, genome_len=20000, seed=9,
                                       error_rate=0.01))
    return str(path)


MESH_CASES = [
    ("k21", dict(k=21, canonical=True), None, ("k1", "k6")),
    ("k55", dict(k=55, canonical=True), None, ("k1", "k6")),
    ("mask", dict(seed_mask="1110111011101110111"), None, ("k1", "k6")),
    ("gapped", dict(gapped=True, max_read_len=160), None, ("k3", "k6")),
    ("legacy", dict(k=21, canonical=True), "legacy", ("k7", "k6"))]


@pytest.mark.parametrize("shape,name,kw,env,kernels", [
    (shape, *case) for shape in ((4, 1), (2, 2)) for case in MESH_CASES] + [
    ((4, 1), "dense", dict(k=8, mode="dense"), None, ("k1", "k5"))])
def test_mesh_on_one_card_equals_cpu(cuda, tmp_path, monkeypatch, shape,
                                     name, kw, env, kernels):
    """count_fasta_multihost over a mesh of positions on cuda:0 equals the
    same mesh on the CPU, each of the path's kernels launched."""
    from kmer_tpu_torch.parallel.mesh import make_mesh
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    if env:
        monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", env)
    path = _mesh_corpus(tmp_path)
    kw = dict(batch_reads=256, **kw)
    want = count_fasta_multihost(path, mesh=make_mesh(
        *shape, devices=["cpu"] * 4), **kw)
    mods = {"k1": fe, "k3": fg, "k5": hk, "k6": sk, "k7": ek}
    for m in mods.values():
        m.launches = 0
    got = count_fasta_multihost(path, mesh=make_mesh(
        *shape, devices=[cuda] * 4), **kw)
    torch.cuda.synchronize()
    assert got == want and got.num_distinct > 0
    for kernel in kernels:
        assert mods[kernel].launches > 0, kernel


def test_one_rank_nccl_group_runs_the_exchange(cuda, tmp_path, monkeypatch):
    """In a one-rank NCCL group the exchange, the all-reduce and the final
    gather go through torch.distributed, and the table equals the one
    without a group."""
    import socket
    import torch.distributed as dist
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    path = _mesh_corpus(tmp_path)
    kw = dict(k=21, canonical=True, batch_reads=256)
    want = kmer_tpu_torch.count_fasta(path, device="cpu", **kw)
    calls = []
    for fn in ("all_to_all_single", "all_reduce", "all_gather"):
        real = getattr(dist, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            calls.append(_fn)
            return _real(*a, **k)
        monkeypatch.setattr(dist, fn, spy)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        got = count_fasta_multihost(path, device="cuda", **kw)
        dense = count_fasta_multihost(path, device="cuda", k=6, mode="dense",
                                      batch_reads=256)
    finally:
        dist.destroy_process_group()
    assert got == want
    assert dense == kmer_tpu_torch.count_fasta(path, device="cpu", k=6,
                                               mode="dense", batch_reads=256)
    assert {"all_to_all_single", "all_reduce", "all_gather"} <= set(calls)


# ------------------------------------------------ keys of any width (W words)

@pytest.mark.parametrize("k,canon,amb,packed", [
    (64, True, False, True), (64, False, True, False),
    (94, True, True, False), (95, False, False, True),
    (101, True, False, True), (101, True, True, False),
    (125, True, False, True), (125, False, True, False)])
def test_multi_word_extract_kernel_equals_plain(cuda, k, canon, amb, packed):
    """K7 on keys of three and four words (W = 3 at k = 64, 94; W = 4 at
    95 to 125), bit for bit, canonical or not, packed and u8 rows."""
    B, L = 301, 160
    host = _wide_batch(k + amb, B, L, amb, packed)
    kw = dict(canonical=canon, mask_ambiguous=amb,
              packed_width=L if packed else 0)
    want = ek.extract_keys(*host, k, **kw)
    before = ek.multi_launches
    got = ek.extract_keys(*(t.to(cuda) for t in host), k, **kw)
    torch.cuda.synchronize()
    assert ek.multi_launches == before + 1
    assert len(got) == len(want) == (3 if k <= 94 else 4)
    assert _same_keys(got, want)
    assert int((want[0] != sk.SENTINEL).sum()) > 0


@pytest.mark.parametrize("B,L,k,canon,packed,amb,short", [
    (301, 161, 101, True, True, False, False),   # tiles end inside rows
    (257, 101, 101, True, False, True, False),   # one window a row
    (333, 102, 100, False, True, False, True),   # P = 3, B P odd
    (129, 160, 64, True, False, True, True),     # W = 3
    (77, 160, 130, True, True, False, False),    # W = 5
    (517, 256, 200, True, False, True, True),    # W = 7
    (300, 1000, 1000, True, True, False, False)])  # too wide: the row body
def test_multi_word_extract_kernel_edges(cuda, B, L, k, canon, packed, amb,
                                         short):
    """K7's multi-word tile body at its edges, and the row body for rows
    too wide to stage, bit for bit; then every row shorter than k (every
    lane a sentinel)."""
    host = _wide_batch(k + B, B, L, amb, packed)
    if not short:
        host[1][:] = L
        host[2][:] = L
    kw = dict(canonical=canon, mask_ambiguous=amb,
              packed_width=L if packed else 0)
    info = ek.launch_info(B, L, k, canonical=canon, mask_ambiguous=amb,
                          packed=packed)
    assert info["body"] == ("row" if k == 1000 else "tile")
    want = ek.extract_keys(*host, k, **kw)
    before = ek.multi_launches
    got = ek.extract_keys(*(t.to(cuda) for t in host), k, **kw)
    torch.cuda.synchronize()
    assert ek.multi_launches == before + 1
    assert _same_keys(got, want)
    assert int((want[0] != sk.SENTINEL).sum()) > 0
    host[1][:] = torch.from_numpy(np.random.default_rng(k).integers(
        0, k, B).astype(np.int32))
    got = ek.extract_keys(*(t.to(cuda) for t in host), k, **kw)
    torch.cuda.synchronize()
    assert all(bool((g == sk.SENTINEL).all()) for g in got)


def test_multi_word_plan_matches_the_wrapper(cuda):
    """extract.cu's multi-word plan equals ops/kernels/extract.wide_plan,
    on given thread slots and on the card's own (SMs x the tile body's
    resident blocks x CUT_THREADS), and launch_info reports it."""
    lib = ek.load()
    for B, L, k, amb in [(8192, 160, 101, False), (2048, 160, 101, True),
                         (1, 64, 64, False), (300, 1000, 1000, False),
                         (4096, 300, 130, True)]:
        for slots in (1, 1000, ek.H100_THREAD_SLOTS, 10 ** 7):
            assert ek.c_wide_plan(lib, B, L, k, amb, slots) == ek.wide_plan(
                B, L, k, amb, slots)
        info = ek.launch_info(B, L, k, canonical=True, mask_ambiguous=amb,
                              packed=not amb)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        plan = ek.wide_plan(B, L, k, amb, sms * info["blocks_per_sm"]
                            * ek.CUT_THREADS)
        assert info["body"] == ("tile" if plan.tile else "row")
        if plan.tile:
            assert info["iters"] == plan.iters and info["smem"] == plan.smem


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb,packed", [
    (27, 27, 80, 140, 160, False, True),     # K3's split, as K3 cuts it
    (27, 27, 60, 70, 66, True, False),       # c_max past L
    (40, 40, 80, 140, 160, False, True),     # the general layout, W = 3
    (40, 40, 90, 100, 150, True, False),
    (32, 5, 40, 52, 96, False, True),        # W = 2, a word across L|R
    (5, 32, 40, 52, 96, True, False),
    (60, 60, 121, 130, 160, False, True),    # W = 4
    (31, 33, 64, 70, 100, True, False)])     # a 32-base last word
def test_gapped_extract_kernel_equals_plain(cuda, llen, rlen, cmin, cmax, L,
                                            amb, packed):
    """K7's gapped entry (the unfused route's lanes), bit for bit."""
    host = _wide_batch(llen + rlen + cmin, 130, L, amb, packed)
    kw = dict(l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax,
              mask_ambiguous=amb, packed_width=L if packed else 0)
    want = ek.extract_gapped_keys(*host, **kw)
    before = ek.gapped_launches
    got = ek.extract_gapped_keys(*(t.to(cuda) for t in host), **kw)
    torch.cuda.synchronize()
    assert ek.gapped_launches == before + 1
    assert _same_keys(got, want)
    assert int((want[0] != sk.SENTINEL).sum()) > 0


@pytest.mark.parametrize("W,N", [(5, 70_001), (6, 30_000)])
def test_sort_kernel_many_planes(cuda, W, N):
    """K6 over 5 and 6 planes: the k = 101 device merge's 4 key words and
    the counts, and 5 key words (k = 126 to 156) and the counts, with the
    general layout's bits (62 a word, 2 b for the last word's b bases, 64
    at 32 bases)."""
    bits = {5: (62, 62, 62, 14), 6: (62, 62, 62, 62, 64)}[W]
    words = _keyed(cuda, W * 7 + N, W, N, bits)
    assert _sort_both(words, num_keys=len(bits), bits=bits) == 1
    assert _sort_both(_keyed(cuda, W, W, N, (64,) * W)) == 1


@pytest.mark.parametrize("W", [4, 5])
def test_grouped_kernels_wide_rows(cuda, W):
    """K2a, and K2b and K2c, over rows of W = 4 and 5 words: W = 5 takes
    K2a's plane loop and the index bodies (no full-row column or warp
    body), and the block body at max_group_rows(W)."""
    planes = _rows(cuda, W, (300, 256), W, sort=True)
    before = gk.run_lengths_launches
    got = gk.run_lengths_grouped(planes)
    want = gk.run_lengths_grouped_ref(planes)
    torch.cuda.synchronize()
    assert gk.run_lengths_launches == before + 1
    assert torch.equal(got, want)
    for fn, ref, counter, shape in (
            (gk.grouped_count, gk.grouped_count_ref, "grouped_launches",
             (300, 256)),
            (gk.grouped_count_strided, gk.grouped_count_strided_ref,
             "strided_launches", (16, 3001)),
            (gk.grouped_count, gk.grouped_count_ref, "grouped_launches",
             (3, gk.max_group_rows(W)))):
        _sort_check(fn, ref, counter, _rows(cuda, W + shape[0], shape, W))
    if W > 4:
        assert gk.launch_info(300, 256, W)["body"] == "warp_index"
        assert gk.launch_info(3001, 16, W,
                              strided=True)["body"] == "column_index"
        assert gk.launch_info(3, gk.max_group_rows(W), W)["body"] == "block"


def _index_case(cuda, seed, shape, W, kind):
    """Rows for the index bodies on the card: "ties" (word 0 from two
    values, later words deciding), "dead_last" (K7-like distinct keys,
    dead rows SENTINEL in every word but a random last one), "dups"
    (every group one row repeated, along dim 1 of `shape`)."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 3, shape) for _ in range(W)]
    if kind == "ties":
        planes[0] = rng.integers(0, 2, shape)
    elif kind == "dead_last":
        planes = [rng.integers(0, 1 << 62, shape) for _ in range(W)]
        dead = rng.random(shape) < 0.2
        for p in planes[:-1]:
            p[dead] = sk.SENTINEL
    else:
        planes = [np.repeat(p[:, :1], shape[1], axis=1) for p in planes]
    return [torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
            for p in planes]


@pytest.mark.parametrize("W", [3, 4, 5, 7, 13])
@pytest.mark.parametrize("m", [2, 16, 64, 256, 512])
@pytest.mark.parametrize("kind", ["ties", "dead_last", "dups"])
def test_grouped_warp_index_body(cuda, W, m, kind):
    """K2b's warp index body (rows of more than WARP_FULL_WORDS words, or
    R W > 32): word-0 ties sorted again by a later word, up to 13 words
    at m = 512 (its widest), G odd with a partial last span."""
    if m > gk.max_group_rows(W):
        return
    G = 2 * (512 // m) + 1
    info = gk.launch_info(G, m, W)
    want = "warp_index" if W > 4 or m == 512 else "warp"
    assert info["body"] == want, info
    _sort_check(gk.grouped_count, gk.grouped_count_ref, "grouped_launches",
                _index_case(cuda, G * m + W, (G, m), W, kind))


@pytest.mark.parametrize("W", [5, 7, 29])
@pytest.mark.parametrize("m", [1, 2, 8, 16])
@pytest.mark.parametrize("kind", ["ties", "dead_last", "dups"])
def test_grouped_column_index_body(cuda, W, m, kind):
    """K2c's column index body (strided columns of m <= 16 rows of over
    64 / m words or W > 4): G odd, over two grids' worth of columns; up to
    29 words at m = 16 (its widest); m = 32 stays on the block body."""
    for G in (129, 2 * 132 * 64 * 7 + 3 if W < 29 else 1001):
        info = gk.launch_info(G, m, W, strided=True)
        assert info["body"] == "column_index", info
        planes = _index_case(cuda, G + m + W, (G, m), W, kind)
        _sort_check(gk.grouped_count_strided, gk.grouped_count_strided_ref,
                    "strided_launches",
                    [p.T.contiguous() for p in planes])
    assert gk.launch_info(129, 32, W, strided=True)["body"] == "block"


@pytest.mark.parametrize("strided", [False, True])
def test_grouped_index_unaligned(cuda, strided):
    """The index bodies on planes 8 bytes past a 16-byte boundary."""
    m, G, W = (16, 1001, 5) if strided else (256, 33, 5)
    base = _rows(cuda, 77, (G * m + 1,), W, hi=3)
    planes = [p[1:].view((m, G) if strided else (G, m)) for p in base]
    assert all(p.data_ptr() % 16 == 8 for p in planes)
    fn, ref, counter = ((gk.grouped_count_strided,
                         gk.grouped_count_strided_ref, "strided_launches")
                        if strided else (gk.grouped_count,
                                         gk.grouped_count_ref,
                                         "grouped_launches"))
    assert gk.launch_info(G, m, W, strided=strided)["body"].endswith(
        "_index")
    _sort_check(fn, ref, counter, planes)


@pytest.mark.parametrize("W", [3, 4])
def test_compact_kernel_records_of_words(cuda, W):
    """K4 on three and four planes: the words as they are, in lane order,
    with the total."""
    planes = _rows(cuda, W, (50_003,), W, hi=1 << 62)
    counts = torch.from_numpy(np.random.default_rng(W).integers(
        -1, 3, 50_003).astype(np.int32)).to(cuda)
    launched, t = _compact_both(planes, counts)
    assert launched == 1 and t == int((counts > 0).sum()) > 0


@pytest.mark.parametrize("kw,env", [
    (dict(k=101, canonical=True), {}),
    (dict(k=101, canonical=True, compact=True), {}),
    (dict(k=101, canonical=True, device_merge="on"), {}),
    (dict(k=101, canonical=True, sort_group_keys=0), {}),
    (dict(k=101, canonical=True), dict(KMER_TPU_STEP="t")),
    (dict(k=101, canonical=True), dict(KMER_TPU_STEP="legacy",
                                       KMER_TPU_GROUPED="pallas")),
    (dict(gapped=True, l_len=40, r_len=40, c_min=80, c_max=100), {}),
    (dict(gapped=True, l_len=40, r_len=40, c_min=80, c_max=100,
          device_merge="on"), {}),
    (dict(gapped=True, l_len=32, r_len=5, c_min=40, c_max=60,
          compact=True), {}),
    (dict(gapped=True, c_min=60, c_max=90), dict(
        KMER_TPU_GAPPED_STEP="legacy"))])
def test_any_width_count_cuda_equals_cpu(cuda, tmp_path, monkeypatch, kw,
                                         env):
    """Keys over 63 bases, gapped windows over 31 and the gapped unfused
    route on the card equal the CPU's tables."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(200, 150, genome_len=3000, seed=9,
                                       error_rate=0.01))
    cfg = kmer_tpu_torch.KmerConfig(batch_reads=64, max_read_len=160, **kw)
    want = kmer_tpu_torch.count_fasta(str(path), cfg, device="cpu")
    ek.multi_launches = ek.gapped_launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), cfg, device="cuda")
    assert got == want and got.num_distinct > 0
    if not cfg.gapped:
        assert got.total == 200 * (150 - 100) and ek.multi_launches > 0
    elif env or max(cfg.l_len, cfg.r_len) > 31:
        assert ek.gapped_launches > 0


# ------------------------------ streaming, `card` and the mesh at W words

@pytest.mark.parametrize("k,b", [(64, 10), (101, 11), (130, 4)])
def test_hll_plane_mode_kernel_equals_plain(cuda, k, b):
    """K5's plane mode on K7's W = 3, 4 and 5 planes (u8 rows with
    ambiguous codes, short rows: sentinel lanes at weight 0), into a
    pre-filled histogram, then on views one lane off the allocation's
    alignment."""
    host = _wide_batch(k, 301, 160, True, False)
    planes = ek.extract_keys(*(t.to(cuda) for t in host), k, canonical=True,
                             mask_ambiguous=True)
    assert len(planes) == {64: 3, 101: 4, 130: 5}[k]
    w = (planes[0] != SENTINEL_KEY).to(torch.int8)
    out = torch.arange(1 << (b + 5), dtype=torch.int64, device=cuda)
    before = hk.launches
    got = hk.hll_class_histogram(planes, w, k=k, b=b, out=out.clone())
    want = hk.hll_class_histogram_ref(planes, w, k=k, b=b, out=out.clone())
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert torch.equal(got, want) and int((got - out).sum()) == int(w.sum())
    flat = tuple(p.reshape(-1)[1:] for p in planes)
    got = hk.hll_class_histogram(flat, w.reshape(-1)[:-1], k=k, b=b)
    want = hk.hll_class_histogram_ref(flat, w.reshape(-1)[:-1], k=k, b=b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [64, 101, 130])
def test_hll_plane_mode_kernel_edges(cuda, k):
    """An empty stream launches nothing; a stream of sentinel lanes only
    (weight 0) launches and adds nothing; random weights of either sign
    on random keys equal the plain version."""
    W = words64(k)
    empty = tuple(torch.zeros(0, dtype=torch.int64, device=cuda)
                  for _ in range(W))
    before = hk.launches
    got = hk.hll_class_histogram(empty, torch.zeros(0, dtype=torch.int8,
                                                    device=cuda), k=k, b=10)
    assert hk.launches == before and int(got.abs().sum()) == 0
    n = 70_001
    dead = tuple(torch.full((n,), SENTINEL_KEY, dtype=torch.int64, device=cuda)
                 for _ in range(W))
    got = hk.hll_class_histogram(dead, torch.zeros(n, dtype=torch.int8,
                                                   device=cuda), k=k, b=10)
    torch.cuda.synchronize()
    assert hk.launches == before + 1 and int(got.abs().sum()) == 0
    rng = np.random.default_rng(k)
    planes = tuple(torch.from_numpy(rng.integers(0, 1 << (2 * nb), n)).to(
        cuda) for nb in word_bases(k))
    w = torch.from_numpy(rng.integers(-3, 4, n).astype(np.int8)).to(cuda)
    got = hk.hll_class_histogram(planes, w, k=k, b=10)
    want = hk.hll_class_histogram_ref(planes, w, k=k, b=10)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.sum()) == int(w.sum())


@pytest.mark.parametrize("n,k", [(1, 130), (31, 101), (70_001, 64),
                                 (70_001, 101), (70_001, 130), (33_333, 160),
                                 (33_333, 250)])
def test_hll_plane_mode_kernel_lane_counts(cuda, n, k):
    """K5's plane mode at lane counts no multiple of 32, W = 3 to 6 (a
    key's words in registers) and W = 9 (loaded in turn): random keys,
    weights of either sign, a tenth of the lanes dead."""
    rng = np.random.default_rng(n + k)
    keys = [rng.integers(0, 1 << (2 * nb), n) if nb < 32 else
            rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
            for nb in word_bases(k)]
    w = rng.integers(-3, 4, n).astype(np.int8)
    dead = rng.random(n) < 0.1
    w[dead] = 0
    for p in keys:
        p[dead] = SENTINEL_KEY
    planes = tuple(torch.from_numpy(p).to(cuda) for p in keys)
    w = torch.from_numpy(w).to(cuda)
    before = hk.launches
    got = hk.hll_class_histogram(planes, w, k=k, b=10)
    want = hk.hll_class_histogram_ref(planes, w, k=k, b=10)
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert torch.equal(got, want) and int(got.sum()) == int(w.sum())
    regs, _ = hk.attributes(3, len(planes))
    assert regs > 0


def _wide_corpus(tmp_path):
    path = tmp_path / "w.fasta"
    path.write_text(genome_reads_fasta(400, 150, genome_len=4000, seed=19,
                                       error_rate=0.002))
    return str(path)


def test_card_k101_cuda_launches_k7_and_k5(cuda, tmp_path):
    """`card -k 21 -k 101` on the card: K1 at k = 21, K7's multi-word
    entry at k = 101, K5 for both, a batch each; the CPU's estimates."""
    path = _wide_corpus(tmp_path)
    cfg = kmer_tpu_torch.KmerConfig(k=101, canonical=True, batch_reads=64,
                                    max_read_len=160)
    want = kmer_tpu_torch.estimate_distinct_multi_k(path, [21, 101], cfg,
                                                    device="cpu")
    fe.launches = ek.multi_launches = hk.launches = 0
    got = kmer_tpu_torch.estimate_distinct_multi_k(path, [21, 101], cfg,
                                                   device="cuda")
    torch.cuda.synchronize()
    batches = -(-400 // 64)
    assert got == want and want[1][1] == 400 * 50
    assert (fe.launches, ek.multi_launches, hk.launches) == (
        batches, batches, 2 * batches)


@pytest.mark.parametrize("kw", [
    dict(k=101, canonical=True, device_merge="off"),
    dict(k=101, canonical=True, device_merge="on"),
    dict(gapped=True, l_len=40, r_len=40, c_min=80, c_max=100,
         device_merge="on")])
def test_streaming_wide_cuda_equals_cpu(cuda, tmp_path, kw):
    """StreamingCounter at k = 101 and gapped 40/40 on the card, paused
    after 3 batches and resumed by a fresh counter: the single-device
    in-memory table; K7 a batch, K6 on the device merge."""
    path = _wide_corpus(tmp_path)
    cfg = kmer_tpu_torch.KmerConfig(batch_reads=64, max_read_len=160,
                                    partitions=5, **kw)
    want = kmer_tpu_torch.count_fasta(path, cfg, device="cpu")
    spill = str(tmp_path / "sp")
    ek.launches = ek.gapped_launches = sk.launches = 0
    sc = kmer_tpu_torch.StreamingCounter(path, cfg, spill, device="cuda")
    sc.run_pass1(max_batches=3)
    sc = kmer_tpu_torch.StreamingCounter(path, cfg, spill, device="cuda")
    sc.run()
    assert sc.final_table() == want and want.num_distinct > 0
    assert (ek.launches + ek.gapped_launches
            == sc.state["pass1_next_batch"])
    assert (sk.launches > 0) == (kw["device_merge"] == "on")


@pytest.mark.parametrize("shape,kw,env", [
    ((4, 1), dict(k=101, canonical=True), None),
    ((2, 2), dict(k=101, canonical=True), None),
    ((1, 4), dict(k=101, canonical=True), None),
    ((2, 2), dict(k=101, canonical=True), "legacy"),
    ((2, 1), dict(gapped=True, l_len=40, r_len=40, c_min=80, c_max=100),
     None)])
def test_mesh_wide_cuda_equals_single_device(cuda, tmp_path, monkeypatch,
                                             shape, kw, env):
    """count_fasta_multihost at k = 101 (multi-hop halos on the seq
    meshes) and gapped 40/40 over positions on cuda:0: the single-device
    table, K7 and K6 launched."""
    from kmer_tpu_torch.parallel.mesh import make_mesh
    from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
    if env:
        monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", env)
    path = _wide_corpus(tmp_path)
    cfg = kmer_tpu_torch.KmerConfig(batch_reads=64, max_read_len=160, **kw)
    want = kmer_tpu_torch.count_fasta(path, cfg, device="cpu")
    ek.launches = ek.gapped_launches = sk.launches = 0
    got = count_fasta_multihost(path, cfg, mesh=make_mesh(
        *shape, devices=[cuda] * (shape[0] * shape[1])))
    torch.cuda.synchronize()
    assert got == want and want.num_distinct > 0
    assert ek.launches + ek.gapped_launches > 0 and sk.launches > 0
