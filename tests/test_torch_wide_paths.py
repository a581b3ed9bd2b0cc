"""Keys of any width on streaming, `card` and the mesh, against kmer_tpu
on the CPU, exactly (integer keys and counts: tolerance zero; estimates
are the same float):

- `card`: estimates and totals equal kmer_tpu's estimate_distinct_multi_k
  at k = 64, 101 and 130, canonical or not, with skip_invalid, and for
  the list [21, 101]; hll_classes of W-plane keys equal kmer_tpu's on
  its uint32 words; a numpy copy of K5's plane mode (the 128-bit funnel
  of csrc/histogram.cu) gives the same classes; `card -k 101` bytes;
- streaming two-pass at k = 64 and 101 and gapped (40, 40) and (32, 5),
  per batch and through the device merge, paused after 3 batches and
  resumed by a fresh counter: each partition table and the final table
  equal kmer_tpu's StreamingCounter's; route_fused past two columns
  equals kmer_tpu's route_partition; `count --two-pass -k 101` and
  `histo --two-pass -k 101` bytes;
- the mesh: the pairs and sorted-stream steps at k = 64 and 101 and
  gapped (40, 40) and (32, 5) over (8, 1), (4, 2) and (1, 8) positions,
  owner by owner against kmer_tpu's sorted stream on 8 virtual devices;
  count_fasta_multihost (gather=False) over (2, 1), (2, 2) and (1, 4)
  and the legacy step; the gapped (32, 5) layout (31, 6) over a (2, 1)
  mesh; StreamingCounter(mesh=) paused on (2, 1) and resumed on (4, 1);
  two gloo processes at k = 101;
- a seed mask selecting 64 bases raises kmer_tpu's ValueError.

kmer_tpu is imported only as the reference; inputs are made from seeds
with numpy.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io.generator import genome_reads_fasta
from kmer_tpu.ops import encode as jenc
from kmer_tpu.ops import sketch as jsketch
from kmer_tpu.pipeline.sketch import estimate_distinct_multi_k as jax_card
from kmer_tpu.pipeline.streaming import StreamingCounter as JaxCounter
from kmer_tpu.pipeline.streaming import route_partition as jax_route
from kmer_tpu_torch import KmerConfig, StreamingCounter
from kmer_tpu_torch.cli import main as port_main
from kmer_tpu_torch.ops import encode as tenc
from kmer_tpu_torch.ops.kernels import histogram as hk
from kmer_tpu_torch.ops.sketch import hll_classes
from kmer_tpu_torch.parallel import distributed as td
from kmer_tpu_torch.parallel.mesh import make_mesh
from kmer_tpu_torch.parallel.multihost import count_fasta_multihost
from kmer_tpu_torch.pipeline import streaming
from kmer_tpu_torch.pipeline.sketch import estimate_distinct_multi_k
from kmer_tpu_torch.pipeline.table import KmerTable, fuse_words

import test_torch_distributed as dist_tests
from test_torch_multihost import _free_port, _run_pair

CPU = dict(device="cpu")
BASE = dict(batch_reads=8, max_read_len=160, sort_group_keys=64)
# the widths of this file: a 3-word and a 4-word contiguous key, gapped
# windows over 31 bases (L||R in 3 words), and gapped (32, 5), whose
# layout is (31, 6): two planes that are not K3's (l_len, r_len) split
WIDE = {
    "k64": dict(k=64),
    "k101": dict(k=101, canonical=True),
    "g40": dict(gapped=True, l_len=40, r_len=40, c_min=80, c_max=100),
    "g32_5": dict(gapped=True, l_len=32, r_len=5, c_min=37, c_max=60),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Genome reads (5 batches of 8), and reads of mixed lengths with
    ambiguous bases (skip_invalid)."""
    d = tmp_path_factory.mktemp("wide_paths")
    g = d / "g.fasta"
    g.write_text(genome_reads_fasta(40, 150, genome_len=1500, seed=12,
                                    error_rate=0.002))
    rng = np.random.default_rng(19)
    seqs = ["".join("ACGTN"[c] for c in np.where(
        rng.random(n) < 0.01, 4, rng.integers(0, 4, n)))
        for n in rng.integers(90, 260, 30)]
    amb = d / "amb.fasta"
    amb.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return {"g": str(g), "amb": str(amb)}


def _cfg(name, **kw):
    return KmerConfig(mode="sort", **{**BASE, **WIDE[name], **kw})


def _jax_cfg(name, **kw):
    return kmer_tpu.KmerConfig(mode="sort", **{**BASE, **WIDE[name], **kw})


# ------------------------------------------------------------------ card

@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [64, 101, 130])
def test_card_equals_kmer_tpu(corpus, k, canonical, skip):
    path = corpus["amb" if skip else "g"]
    kw = dict(k=k, canonical=canonical, skip_invalid=skip, batch_reads=8,
              max_read_len=160)
    want = jax_card([path], [k], kmer_tpu.KmerConfig(**kw))
    got = estimate_distinct_multi_k([path], [k], KmerConfig(**kw), **CPU)
    assert got == want and got[0][1] > 0


def test_card_multi_k_mixes_narrow_and_wide(corpus):
    kw = dict(k=101, canonical=True, batch_reads=8, max_read_len=160)
    want = jax_card([corpus["g"]], [21, 101], kmer_tpu.KmerConfig(**kw))
    got = estimate_distinct_multi_k([corpus["g"]], [21, 101],
                                    KmerConfig(**kw), **CPU)
    assert got == want and len(got) == 2


def _codes_words(rng, n: int, M: int = 300):
    """(M, n) codes with the all-A and all-T rows, and kmer_tpu's uint32
    key words."""
    codes = rng.integers(0, 4, (M, n), dtype=np.uint8)
    codes[0], codes[1] = 0, 3
    return np.stack([jenc.key_words_from_codes(c) for c in codes])


WIDTHS = [32, 63, 64, 94, 95, 96, 101, 125, 126, 130, 160]


@pytest.mark.parametrize("b", [4, 10, 11])
@pytest.mark.parametrize("n", WIDTHS)
def test_hll_classes_of_planes_equal_kmer_tpu(n, b):
    words = _codes_words(np.random.default_rng(n + b), n)
    planes = tenc.u32_to_planes(words, tenc.word_bases(n))
    got = hll_classes(tuple(torch.from_numpy(p) for p in planes), n, b)
    want, _ = jsketch.hll_classes([words[:, j] for j in
                                   range(words.shape[1])],
                                  np.ones(len(words), bool), b)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


_M32 = 0xFFFFFFFF


def _mix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _plane_bin_model(row, k: int, b: int) -> int:
    """A copy of csrc/histogram.cu's plane_bin (MODE 3) on Python ints:
    each plane's 64 bits ORed into a 128-bit funnel after a shift by its
    value bits, each complete 32-bit word hashed once the next plane can
    no longer reach it, most significant first."""
    W = len(row)
    n_words = (2 * k + 1 + 31) // 32
    rest = k - 31 * (W - 1)
    last_bits = 64 if rest == 32 else 2 * rest
    h, funnel, pending = 0x9E3779B9, 0, 32 * n_words - 2 * k
    assert 1 <= pending <= 32
    for j, v in enumerate(row):
        v = int(v) & ((1 << 64) - 1)
        bits, reach = 62, 0
        if j == W - 1:
            bits = last_bits
            if bits == 64:
                v ^= 1 << 63
        else:
            reach = 64 - (last_bits if j + 1 == W - 1 else 62)
        funnel = ((funnel << bits) | v) & ((1 << 128) - 1)
        pending += bits
        assert pending < 96
        while pending >= 32 + reach:
            pending -= 32
            word = (funnel >> pending) & _M32
            h = _mix32((((h ^ word) * 0x01000193) + 0x811C9DC5) & _M32)
    assert pending == 0
    width = 32 - b
    tail = h & ((1 << width) - 1)
    return (h >> width) * 32 + min(width - tail.bit_length() + 1, 31)


@pytest.mark.parametrize("n", [64, 94, 95, 96, 101, 125, 126, 160, 190])
def test_k5_plane_mode_model_equals_kmer_tpu(n):
    words = _codes_words(np.random.default_rng(n), n, M=120)
    planes = tenc.u32_to_planes(words, tenc.word_bases(n))
    want, _ = jsketch.hll_classes([words[:, j] for j in
                                   range(words.shape[1])],
                                  np.ones(len(words), bool), 10)
    got = [_plane_bin_model([p[i] for p in planes], n, 10)
           for i in range(len(words))]
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n", [64, 78, 94, 101, 109, 126, 141, 190])
def test_k5_plane_mode_model_equals_plain_on_any_int64(n):
    """Planes that hold no key (sentinels, any int64, negatives): the
    kernel's funnel and the plain version hash the same words, also where
    a plane's place is a word boundary (n = 78, 109, 141)."""
    rng = np.random.default_rng(n)
    W = tenc.words64(n)
    planes = [rng.integers(-(1 << 63), (1 << 63) - 1, 200, dtype=np.int64,
                           endpoint=True) for _ in range(W)]
    for p in planes:
        p[:20] = tenc.SENTINEL_KEY
        p[20:30] = -1
    want = hll_classes(tuple(torch.from_numpy(p) for p in planes), n, 10)
    got = [_plane_bin_model([p[i] for p in planes], n, 10)
           for i in range(200)]
    np.testing.assert_array_equal(got, want.numpy())


def test_hll_class_histogram_plain_and_layout_checks():
    """The plain version over W planes with weights (sentinel lanes at
    weight 0), and a key of the wrong plane count refused."""
    n = 101
    words = _codes_words(np.random.default_rng(3), n)
    planes = [torch.from_numpy(p) for p in
              tenc.u32_to_planes(words, tenc.word_bases(n))]
    weight = torch.from_numpy(
        np.random.default_rng(4).integers(0, 3, len(words)).astype(np.int8))
    for p in planes:
        p[weight == 0] = tenc.SENTINEL_KEY
    got = hk.hll_class_histogram(tuple(planes), weight, k=n, b=10)
    cls = hll_classes(tuple(p[weight > 0] for p in planes), n, 10)
    want = torch.zeros(1 << 15, dtype=torch.int64).index_add_(
        0, cls, weight[weight > 0].to(torch.int64))
    assert torch.equal(got, want) and int(got.sum()) == int(weight.sum())
    with pytest.raises(ValueError, match="words64"):
        hk.hll_class_histogram(tuple(planes[:2]), weight, k=n, b=10)
    with pytest.raises(ValueError, match="words64"):
        hk.hll_class_histogram(planes[0], weight, k=n, b=10)


@pytest.mark.parametrize("ks", [["101"], ["21", "101"], ["130"]])
def test_cli_card_bytes(corpus, capsys, ks):
    args = ["card", corpus["g"], "--canonical", "--batch-reads", "8",
            "--max-read-len", "160"] + [a for k in ks for a in ("-k", k)]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert port_main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want


# ------------------------------------------------------------- streaming

@pytest.fixture(scope="module")
def jax_streams(corpus, tmp_path_factory):
    """kmer_tpu's StreamingCounter of each width: (partition tables,
    final table)."""
    out = {}
    for name in WIDE:
        d = tmp_path_factory.mktemp(f"jax_{name}")
        sc = JaxCounter(corpus["g"], _jax_cfg(name, partitions=5), str(d))
        sc.run()
        out[name] = ([t for _, t in sc.partition_tables()],
                     sc.final_table())
    return out


@pytest.mark.parametrize("route", ["off", "on"])
@pytest.mark.parametrize("name", list(WIDE))
def test_streaming_resumed_equals_kmer_tpu(corpus, jax_streams, tmp_path,
                                           name, route):
    """Per batch (off) and through the device merge (on): paused after 3
    batches, resumed by a fresh counter; every partition table equals
    kmer_tpu's."""
    cfg = _cfg(name, partitions=5, device_merge=route)
    sp = str(tmp_path / "sp")
    sc = StreamingCounter(corpus["g"], cfg, sp, **CPU)
    sc.run_pass1(max_batches=3)
    assert sc.state["pass1_next_batch"] == 3 and not sc.state["pass1_done"]
    sc = StreamingCounter(corpus["g"], cfg, sp, **CPU)
    sc.run()
    assert sc.cols == tenc.fused_columns(cfg.n_bases)
    want_parts, want = jax_streams[name]
    got_parts = [t for _, t in sc.partition_tables()]
    assert len(got_parts) == len(want_parts) == 5
    for got, exp in zip(got_parts, want_parts):
        assert got == exp
    assert sc.final_table() == want and want.num_distinct > 1000
    # each spill record is the key's fused columns and its count
    rec_bytes = 8 * (sc.cols + 1)
    assert all(b % rec_bytes == 0 for b in sc.state["part_bytes"])


@pytest.mark.parametrize("parts", [1, 3, 16, 1000])
@pytest.mark.parametrize("n_bases", [64, 65, 94, 95, 96, 101, 128, 160])
def test_route_fused_wide_equals_route_partition(n_bases, parts):
    """Three to five fused columns: the ids equal kmer_tpu's of the
    uint32 words, and do not decrease along sorted keys."""
    rng = np.random.default_rng(n_bases * 11 + parts)
    codes = rng.integers(0, 4, (400, n_bases))
    codes[:10], codes[10:20] = 0, 3
    words = np.stack([jenc.key_words_from_codes(c, n_bases) for c in codes])
    fused = fuse_words(words, n_bases)
    assert fused.shape[1] == tenc.fused_columns(n_bases) >= 3
    got = streaming.route_fused(fused, n_bases, parts)
    np.testing.assert_array_equal(got, jax_route(words, n_bases, parts))
    order = np.lexsort(fused.T[::-1])
    assert np.all(np.diff(got[order]) >= 0)
    assert got.min() >= 0 and got.max() < parts


@pytest.mark.parametrize("cmd", ["count", "histo"])
def test_cli_two_pass_k101_bytes(corpus, tmp_path, capsys, cmd):
    args = [cmd, corpus["g"], "-k", "101", "--canonical", "--batch-reads",
            "8", "--max-read-len", "160", "--two-pass", "--partitions", "4",
            "--spill-dir"]
    assert jax_main(args + [str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out
    assert port_main(args + [str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.count("\n") > 1


# ------------------------------------------------------------------ mesh

STEPS = {
    "k64": ("make_distributed_count", dict(k=64)),
    "k101": ("make_distributed_count", dict(k=101, canonical=True)),
    "g40": ("make_distributed_gapped",
            dict(l_len=40, r_len=40, c_min=80, c_max=100)),
    "g32_5": ("make_distributed_gapped",
              dict(l_len=32, r_len=5, c_min=37, c_max=60)),
}


@pytest.mark.parametrize("pairs", [True, False])
@pytest.mark.parametrize("shape", dist_tests.SHAPES)
@pytest.mark.parametrize("name", list(STEPS))
def test_mesh_steps_equal_kmer_tpu_owner_by_owner(name, shape, pairs):
    """The pairs step and the sorted stream on 8 CPU positions (seq
    shards of 16 bases against halos of 63 to 99: several hops) against
    kmer_tpu's sorted stream on its 8 virtual devices, owner by owner."""
    maker, kw = STEPS[name]
    n = kw.get("k") or kw["l_len"] + kw["r_len"]
    bases = (tenc.word_bases(n) if "k" in kw
             else tenc.gapped_bases(kw["l_len"], kw["r_len"]))
    port = dist_tests._port_out(
        lambda m: getattr(td, maker + ("_pairs" if pairs else ""))(m, **kw),
        shape, 5, False, n, bases)
    dist_tests._same(port, dist_tests._jax_out(maker, 5, False, **kw))
    _, _, routed = port
    assert all(len(w) == len(bases) for w, _ in routed)


@pytest.fixture(scope="module")
def jax_tables(corpus):
    return {name: kmer_tpu.count_fasta(corpus["g"], _jax_cfg(name))
            for name in WIDE}


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("name", ["k101", "g40", "g32_5"])
def test_count_fasta_multihost_equals_kmer_tpu(corpus, jax_tables, name,
                                               shape):
    mesh = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    got = count_fasta_multihost(corpus["g"], _cfg(name), gather=False,
                                mesh=mesh)
    assert got == jax_tables[name] and got.num_distinct > 1000
    assert int(mesh.stats["owner_rows"].sum()) > 0
    if shape[1] > 1:
        assert mesh.stats["halo_bytes"] > 0


def test_gapped_32_5_layout_over_a_mesh(corpus, jax_tables):
    """Gapped (32, 5) keys travel as the planes (31, 6), not K3's
    (l_len, r_len) split: the host reads them by the layout's bases."""
    assert _cfg("g32_5").plane_bases == (31, 6)
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    got = count_fasta_multihost(corpus["g"], _cfg("g32_5"), mesh=mesh)
    assert got == jax_tables["g32_5"]
    assert got == kmer_tpu.count_fasta(corpus["g"], _jax_cfg("g32_5"))


@pytest.mark.parametrize("name", ["k101", "g40"])
def test_legacy_step_equals_kmer_tpu(corpus, jax_tables, monkeypatch, name):
    monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", "legacy")
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    got = count_fasta_multihost(corpus["g"], _cfg(name), mesh=mesh)
    assert got == jax_tables[name]


def test_streaming_mesh_k101_pause_resume_across_shapes(corpus, jax_tables,
                                                        tmp_path):
    cfg = _cfg("k101")
    sp = str(tmp_path / "sp")
    sc = StreamingCounter(corpus["g"], cfg, sp,
                          mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    sc.run_pass1(max_batches=3)
    assert sc.state["pass1_next_batch"] == 3
    sc = StreamingCounter(corpus["g"], cfg, sp,
                          mesh=make_mesh(4, 1, devices=["cpu"] * 4))
    sc.run()
    assert sc.final_table() == jax_tables["k101"]


_WORKER = """
import os
import sys
coordinator, pid, fasta, outdir = sys.argv[1:5]
import numpy as np
import torch.distributed as dist
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.parallel.mesh import make_mesh
from kmer_tpu_torch.parallel.multihost import (count_fasta_multihost,
                                               initialize,
                                               local_owner_positions)
from kmer_tpu_torch.pipeline.streaming import route_partition
initialize(coordinator, 2, int(pid), device="cpu")
mesh = make_mesh(devices=["cpu", "cpu"])
cfg = KmerConfig(k=101, canonical=True, batch_reads=8, max_read_len=160,
                 sort_group_keys=64)
count_fasta_multihost(fasta, cfg, mesh=mesh).save(f"{outdir}/t{pid}.npz")
part = count_fasta_multihost(fasta, cfg, gather=False, mesh=mesh)
part.save(f"{outdir}/part{pid}.npz")
dest = set(np.unique(route_partition(part.keys, 101, mesh.n_dev)).tolist())
assert dest <= set(local_owner_positions(mesh)), dest
assert "jax" not in sys.modules and "kmer_tpu" not in sys.modules
dist.destroy_process_group()
"""


def test_two_processes_gloo_k101(corpus, tmp_path):
    d = str(tmp_path)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    _run_pair([[sys.executable, str(worker), coord, str(pid), corpus["g"],
                d] for pid in range(2)])
    want = kmer_tpu.count_fasta(corpus["g"], _jax_cfg("k101"))
    t0, t1 = (KmerTable.load(f"{d}/t{i}.npz") for i in range(2))
    assert t0 == t1 == want
    p0, p1 = (KmerTable.load(f"{d}/part{i}.npz") for i in range(2))
    assert p0.num_distinct and p1.num_distinct
    assert p0.merge(p1) == want


# ------------------------------------------------------------ seed masks

def test_seed_mask_over_63_bases_raises_kmer_tpus_error():
    with pytest.raises(ValueError) as want:
        kmer_tpu.KmerConfig(seed_mask="1" * 64)
    with pytest.raises(ValueError) as got:
        KmerConfig(seed_mask="1" * 64)
    assert str(got.value) == str(want.value)
    assert type(got.value) is ValueError
    KmerConfig(seed_mask="1" * 63)


def test_ab_histogram_script_imports_no_jax():
    """scripts/ab_histogram.py runs on the card's machine: torch, numpy
    and the port only."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "scripts", "ab_histogram.py")
    with open(path) as f:
        text = f.read()
    assert "def main" in text
    assert not re.search(r"^\s*(import|from)\s+(jax|kmer_tpu)\b", text,
                         re.M)
