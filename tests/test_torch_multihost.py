"""The port's multi-process count (kmer_tpu_torch.parallel.multihost),
StreamingCounter(mesh=) and `count --multihost` against kmer_tpu on the
CPU, exactly:

- count_fasta_multihost on in-process CPU meshes of (4, 1), (2, 2) and
  (1, 4) positions equals kmer_tpu's count_fasta_multihost (its 8
  virtual devices) and count_fasta, for k = 21 and 45, a spaced mask,
  gapped chunks under chunked ingest, skip-invalid, dense k = 8 and the
  legacy sorted stream;
- a corpus whose keys all go to one owner counts exactly, every routed
  row landing on that owner (no capacity, so nothing overflows);
- scan_record_offsets, host_record_range and the chunked host batches
  equal kmer_tpu's; an empty input keeps its key width; initialize is a
  no-op for one process;
- StreamingCounter(mesh=) paused and resumed on another mesh shape, and
  with no mesh, gives kmer_tpu's table; the device merge is refused;
- two real processes over gloo (jax-free workers, 2 CPU positions each):
  both hold the single-process table, for k = 21, gapped chunks, a mask,
  k = 45, dense k = 8 and a (2, 2) mesh, and gather=False covers exactly
  each process's owners; unequal positions a process are refused;
  `count --multihost` on two processes prints, on process 0, the bytes
  of kmer_tpu's single-process `count`.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import kmer_tpu
from kmer_tpu.cli import main as jax_main
from kmer_tpu.io import fasta as jf
from kmer_tpu.io.generator import random_reads_fasta
from kmer_tpu.parallel import multihost as jmh
from kmer_tpu.utils import oracle
from kmer_tpu_torch import KmerConfig, count_fasta
from kmer_tpu_torch.cli import main as port_main
from kmer_tpu_torch.io import fasta as tf
from kmer_tpu_torch.ops.encode import words_per_key
from kmer_tpu_torch.parallel import multihost as tmh
from kmer_tpu_torch.parallel.mesh import make_mesh
from kmer_tpu_torch.pipeline.streaming import StreamingCounter
from kmer_tpu_torch.pipeline.table import KmerTable

from test_torch_count import REPO

MESHES = [(4, 1), (2, 2), (1, 4)]
BASE = dict(batch_reads=8, max_read_len=96)
CONFIGS = {
    "k21": dict(k=21, canonical=True),
    "k45": dict(k=45, canonical=True),
    "mask": dict(seed_mask="1101011", canonical=True),
    "gapped": dict(gapped=True, l_len=5, r_len=5, c_min=12, c_max=40,
                   ingest_chunk_bases=512),
    "skip": dict(k=21, skip_invalid=True),
    "dense": dict(k=8, mode="dense"),
}


def _cfg(name, **kw):
    return KmerConfig(**BASE, **CONFIGS[name], **kw)


def _jax_cfg(name):
    return kmer_tpu.KmerConfig(**BASE, **CONFIGS[name])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    fa = d / "mh.fasta"
    fa.write_text(random_reads_fasta(37, 90, seed=77))
    rng = np.random.default_rng(3)
    amb = d / "amb.fasta"
    seqs = ["".join("ACGTN"[c] for c in np.where(
        rng.random(n) < 0.02, 4, rng.integers(0, 4, n)))
        for n in rng.integers(30, 150, 29)]
    amb.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return {"fa": str(fa), "amb": str(amb), "dir": d}


def _path(corpus, name):
    return corpus["amb"] if name == "skip" else corpus["fa"]


@pytest.fixture(scope="module")
def jax_tables(corpus):
    """kmer_tpu's count_fasta_multihost (8 virtual devices) and
    count_fasta of each config, computed once."""
    out = {}
    for name in CONFIGS:
        path = _path(corpus, name)
        got = jmh.count_fasta_multihost(path, _jax_cfg(name))
        ref = kmer_tpu.count_fasta(path, _jax_cfg(name))
        assert got == ref
        out[name] = ref
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_count_fasta_multihost_equals_kmer_tpu(corpus, jax_tables, name,
                                               shape):
    if name == "dense" and shape[1] > 1:
        shape = (shape[0] * shape[1], 1)           # dense splits rows only
    mesh = make_mesh(*shape, devices=["cpu"] * 4)
    got = tmh.count_fasta_multihost(_path(corpus, name), _cfg(name),
                                    mesh=mesh)
    want = jax_tables[name]
    assert got.num_distinct > 0
    assert got == want
    assert got.k == want.k and got.keys.dtype == np.uint32
    if name != "dense":
        assert mesh.stats["exchange_bytes"] > 0
        assert int(mesh.stats["owner_rows"].sum()) > 0
    if shape[1] > 1:
        assert mesh.stats["halo_bytes"] > 0


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["k21", "k45", "gapped"])
def test_legacy_step_equals_kmer_tpu(corpus, jax_tables, monkeypatch, name,
                                     shape):
    monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", "legacy")
    mesh = make_mesh(*shape, devices=["cpu"] * 4)
    got = tmh.count_fasta_multihost(corpus["fa"], _cfg(name), mesh=mesh)
    assert got == jax_tables[name]


def test_legacy_refuses_spaced_seeds(corpus, monkeypatch):
    monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", "legacy")
    with pytest.raises(ValueError, match="spaced seeds need the pairs step"):
        tmh.count_fasta_multihost(corpus["fa"], _cfg("mask"),
                                  mesh=make_mesh(2, 1, devices=["cpu"] * 2))


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("canonical", [False, True])
def test_single_owner_corpus_is_exact(tmp_path, n_dev, canonical):
    """Poly-A reads with substitutions only in their last k - 4 bases:
    every window starts with AAAA, so every key (canonical too) routes to
    owner 0, which takes every routed row; the table is exact."""
    k = 21
    rng = np.random.default_rng(n_dev)
    seqs = []
    for n in rng.integers(60, 96, 40):
        s = np.zeros(n, np.int64)
        tail = np.arange(n - k + 4, n)
        hit = tail[rng.random(len(tail)) < 0.3]
        s[hit] = rng.integers(1, 4, len(hit))
        seqs.append("".join("ACGT"[c] for c in s))
    fa = tmp_path / "skew.fasta"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    mesh = make_mesh(n_dev, 1, devices=["cpu"] * n_dev)
    got = tmh.count_fasta_multihost(str(fa), k=k, canonical=canonical,
                                    mesh=mesh, **BASE)
    want = oracle.oracle_count(seqs, k, canonical)
    assert got.to_dict() == dict(want)
    rows = mesh.stats["owner_rows"]
    assert rows[0] > 0 and rows[1:].sum() == 0
    assert got == count_fasta(str(fa), k=k, canonical=canonical,
                              device="cpu", **BASE)


# ------------------------------------------------------ ingest helpers

@pytest.mark.parametrize("max_bases", [257, 1 << 20])
def test_scan_record_offsets_equals_parse_seqs_and_kmer_tpu(corpus,
                                                            max_bases):
    for path, amb in ((corpus["fa"], False), (corpus["amb"], True)):
        want = tf.parse_seqs(path, allow_ambiguous=amb)[1]
        got = tf.scan_record_offsets(path, max_bases=max_bases,
                                     allow_ambiguous=amb)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jf.scan_record_offsets(
            path, max_bases=max_bases, allow_ambiguous=amb))
    empty = corpus["dir"] / "empty.fasta"
    empty.write_text("")
    np.testing.assert_array_equal(tf.scan_record_offsets(str(empty)), [0])


def test_host_record_range_equals_kmer_tpu():
    for n in (0, 1, 7, 64, 1001):
        for pc in (1, 2, 3, 8):
            for pid in range(pc):
                assert (tmh.host_record_range(n, pid, pc)
                        == jmh.host_record_range(n, pid, pc))
    assert tmh.host_record_range(10) == (0, 10)      # one process


@pytest.mark.parametrize("packed", [False, True])
def test_iter_host_batches_chunked_equals_kmer_tpu(tmp_path, packed):
    fa = tmp_path / "c.fasta"
    fa.write_text(random_reads_fasta(23, 70, seed=5))
    cfg = KmerConfig(k=11, batch_reads=4, max_read_len=48,
                     ingest_chunk_bases=257)
    jcfg = kmer_tpu.KmerConfig(k=11, batch_reads=4, max_read_len=48,
                               ingest_chunk_bases=257)
    n = len(tf.scan_record_offsets(str(fa), max_bases=257)) - 1
    for s, e in [(0, n), (0, (n + 1) // 2), ((n + 1) // 2, n), (3, 5),
                 (n, n)]:
        got = list(tmh._iter_host_batches_chunked(str(fa), cfg, s, e, 4,
                                                  packed=packed))
        want = list(jmh._iter_host_batches_chunked(str(fa), jcfg, s, e, 4))
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            codes = tf.pack_batch_codes(wb.codes) if packed else wb.codes
            np.testing.assert_array_equal(gb.codes, codes)
            np.testing.assert_array_equal(gb.lengths, wb.lengths)
            np.testing.assert_array_equal(gb.start_limits, wb.start_limits)


def test_empty_input_keeps_key_width(tmp_path):
    fa = tmp_path / "empty.fasta"
    fa.write_text("")
    for cfg in (KmerConfig(gapped=True, c_min=60, c_max=64, batch_reads=8,
                           max_read_len=64),
                KmerConfig(seed_mask="110101011", batch_reads=8,
                           max_read_len=64),
                KmerConfig(k=21, batch_reads=8, max_read_len=64),
                KmerConfig(k=45, batch_reads=8, max_read_len=64)):
        for shape in ((4, 1), (2, 2)):
            t = tmh.count_fasta_multihost(
                str(fa), cfg, mesh=make_mesh(*shape, devices=["cpu"] * 4))
            assert t.num_distinct == 0 and t.k == cfg.n_bases
            assert t.keys.shape == (0, words_per_key(cfg.n_bases))


def test_initialize_single_process_noop(monkeypatch):
    import torch.distributed as dist
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    tmh.initialize(num_processes=1)
    tmh.initialize(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tmh.initialize(coordinator_address="127.0.0.1:1", device="cpu")


def test_batch_reads_checks(corpus):
    with pytest.raises(ValueError, match="device count=4"):
        tmh.count_fasta_multihost(corpus["fa"], k=21, batch_reads=6,
                                  mesh=make_mesh(4, 1, devices=["cpu"] * 4))


def test_a_failed_batch_fails_the_count(corpus, monkeypatch):
    """A batch that cannot be read (here: raised after the first) stops
    the count with its error (in one process, at once; across processes,
    test_two_processes_a_failed_batch_fails_both)."""
    real = tmh._iter_host_batches_chunked

    def failing(*a, **kw):
        it = real(*a, **kw)
        yield next(it)
        raise OSError("batch source lost")
    monkeypatch.setattr(tmh, "_iter_host_batches_chunked", failing)
    with pytest.raises(OSError, match="batch source lost"):
        tmh.count_fasta_multihost(corpus["fa"], _cfg("k21"),
                                  mesh=make_mesh(2, 1, devices=["cpu"] * 2))


# ------------------------------------------------------------ streaming

@pytest.mark.parametrize("name", ["k21", "k45", "gapped"])
def test_streaming_mesh_pause_resume_across_shapes(corpus, jax_tables,
                                                   tmp_path, name):
    """Pass 1 paused on a (2, 1) mesh, resumed on a (1, 4) mesh, resumed
    again with no mesh: kmer_tpu's table."""
    cfg = _cfg(name, partitions=4)
    sp = str(tmp_path / "sp")
    StreamingCounter(corpus["fa"], cfg, sp, device="cpu",
                     mesh=make_mesh(2, 1, devices=["cpu"] * 2)).run_pass1(
        max_batches=2)
    sc = StreamingCounter(corpus["fa"], cfg, sp, device="cpu",
                          mesh=make_mesh(1, 4, devices=["cpu"] * 4))
    sc.run_pass1(max_batches=2)
    assert sc.state["pass1_next_batch"] == 4
    last = StreamingCounter(corpus["fa"], cfg, sp, device="cpu")
    last.run()
    assert last.final_table() == jax_tables[name]
    # a whole run on a mesh
    whole = StreamingCounter(corpus["fa"], cfg, str(tmp_path / "w"),
                             device="cpu",
                             mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    whole.run()
    assert whole.final_table() == jax_tables[name]


def test_streaming_mesh_refuses_the_device_merge(corpus, tmp_path):
    with pytest.raises(ValueError, match="not combined with a mesh"):
        StreamingCounter(corpus["fa"], _cfg("k21", device_merge="on"),
                         str(tmp_path / "sp"), device="cpu",
                         mesh=make_mesh(2, 1, devices=["cpu"] * 2))


# ------------------------------------------------------------------- CLI

def _tsv(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_multihost_one_process_bytes(corpus, capsys, tmp_path):
    argv = ["count", corpus["fa"], "-k", "9", "--canonical",
            "--batch-reads", "8", "--max-read-len", "96", "--min-count", "2"]
    rc, want, _ = _tsv(jax_main, argv, capsys)
    assert rc == 0 and want
    npz = str(tmp_path / "t.npz")
    rc, got, _ = _tsv(port_main, argv + ["--multihost", "--device", "cpu",
                                         "--out-npz", npz], capsys)
    assert rc == 0 and got == want
    assert KmerTable.load(npz) == kmer_tpu.count_fasta(
        corpus["fa"], k=9, canonical=True, batch_reads=8,
        max_read_len=96).filter_min_count(2)


@pytest.mark.parametrize("extra", [["--compact"], ["--two-pass"], ["TWO"]])
def test_cli_multihost_errors_equal_kmer_tpu(corpus, capsys, extra):
    files = [corpus["fa"]] * (2 if extra == ["TWO"] else 1)
    argv = ["count", *files, "--multihost"] + [e for e in extra
                                               if e != "TWO"]
    out = []
    for main, prog in ((jax_main, "kmer_tpu"), (port_main, "kmer_tpu_torch")):
        rc, o, err = _tsv(main, argv, capsys)
        out.append((rc, o, err.replace(f"{prog}: error:", "PROG: error:")))
    assert out[0] == out[1] and out[0][0] == 1


# --------------------------------------------------- two real processes

_WORKER = """
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
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = make_mesh(devices=["cpu", "cpu"])
assert (mesh.n_data, mesh.n_seq, mesh.n_dev) == (4, 1, 4)
base = dict(batch_reads=8, max_read_len=96)
runs = {
    "t": KmerConfig(k=21, **base),
    "g": KmerConfig(gapped=True, l_len=5, r_len=5, c_min=12, c_max=16,
                    ingest_chunk_bases=512, **base),
    "s": KmerConfig(seed_mask="1101011", canonical=True, **base),
    "w": KmerConfig(k=45, canonical=True, **base),
    "d": KmerConfig(k=8, mode="dense", **base),
}
for name, cfg in runs.items():
    table = count_fasta_multihost(fasta, cfg, mesh=mesh)
    table.save(f"{outdir}/{name}{pid}.npz")
seq = make_mesh(2, 2, devices=["cpu", "cpu"])
count_fasta_multihost(fasta, runs["g"], mesh=seq).save(f"{outdir}/q{pid}.npz")
pt = count_fasta_multihost(fasta, runs["t"], gather=False, mesh=mesh)
pt.save(f"{outdir}/part{pid}.npz")
mine = set(local_owner_positions(mesh))
dest = set(np.unique(route_partition(pt.keys, 21, mesh.n_dev)).tolist())
assert mine == {2 * int(pid), 2 * int(pid) + 1}
assert dest <= mine, (sorted(dest), sorted(mine))
try:                               # unequal positions are refused
    make_mesh(devices=["cpu"] * (1 + int(pid)))
except ValueError as exc:
    assert "as many" in str(exc), exc
else:
    raise AssertionError("a mesh of 1 + 2 positions was accepted")
assert not any(m == "jax" or m.startswith(("jax.", "kmer_tpu."))
               or m == "kmer_tpu" for m in sys.modules), "imports jax"
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK"):
        env.pop(var, None)
    return env


def _run_pair(cmds, timeout=240):
    procs = [subprocess.Popen(c, env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


_FAULT_WORKER = """
import sys
coordinator, pid, fasta = sys.argv[1:4]
import torch.distributed as dist
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.parallel import multihost as mh
from kmer_tpu_torch.parallel.mesh import make_mesh
mh.initialize(coordinator, 2, int(pid), device="cpu")
real = mh._iter_host_batches_chunked

def failing(*a, **kw):
    it = real(*a, **kw)
    yield next(it)
    raise OSError("batch source lost")
mesh = make_mesh(devices=["cpu", "cpu"])
base = dict(batch_reads=8, max_read_len=96, ingest_chunk_bases=512)
for cfg in (KmerConfig(k=21, **base), KmerConfig(k=8, mode="dense", **base)):
    if pid == "1":
        mh._iter_host_batches_chunked = failing
    try:
        mh.count_fasta_multihost(fasta, cfg, mesh=mesh)
    except (OSError, RuntimeError) as exc:
        print(type(exc).__name__, exc)
    else:
        raise AssertionError("a failed batch did not fail the count")
    mh._iter_host_batches_chunked = real
# both processes left the failed counts at the same collective
print(mh.count_fasta_multihost(fasta, KmerConfig(k=21, **base),
                               mesh=mesh).total)
dist.destroy_process_group()
"""


def test_two_processes_a_failed_batch_fails_both(corpus, tmp_path):
    """Process 1 cannot read its second batch: both processes raise, the
    routed count in the step's size exchange (which carries the fault
    flag) and the dense count at its one check, process 1 with its own
    error; a count after them runs in step on both."""
    worker = tmp_path / "fault_worker.py"
    worker.write_text(_FAULT_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    outs = [o.decode().splitlines() for o in _run_pair(
        [[sys.executable, str(worker), coord, str(pid), corpus["fa"]]
         for pid in range(2)], timeout=120)]
    other = "RuntimeError another process failed to read its batch"
    assert outs[0][:2] == [other, other]
    assert outs[1][:2] == ["OSError batch source lost"] * 2
    want = count_fasta(corpus["fa"], KmerConfig(k=21, **BASE), device="cpu")
    assert outs[0][2] == outs[1][2] == str(want.total)


def test_two_processes_gloo(corpus, tmp_path, capsys):
    d = str(tmp_path)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    _run_pair([[sys.executable, str(worker), coord, str(pid), corpus["fa"],
                d] for pid in range(2)])
    fa = corpus["fa"]
    refs = {
        "t": kmer_tpu.KmerConfig(k=21, **BASE),
        "g": kmer_tpu.KmerConfig(gapped=True, l_len=5, r_len=5, c_min=12,
                                 c_max=16, **BASE),
        "s": kmer_tpu.KmerConfig(seed_mask="1101011", canonical=True,
                                 **BASE),
        "w": kmer_tpu.KmerConfig(k=45, canonical=True, **BASE),
        "d": kmer_tpu.KmerConfig(k=8, mode="dense", **BASE),
    }
    for name, cfg in refs.items():
        t0 = KmerTable.load(f"{d}/{name}0.npz")
        t1 = KmerTable.load(f"{d}/{name}1.npz")
        want = kmer_tpu.count_fasta(fa, cfg)
        assert t0.num_distinct > 0
        assert t0 == t1 == want
    assert (KmerTable.load(f"{d}/q0.npz") == KmerTable.load(f"{d}/q1.npz")
            == kmer_tpu.count_fasta(fa, refs["g"]))
    p0, p1 = (KmerTable.load(f"{d}/part{i}.npz") for i in range(2))
    ref = kmer_tpu.count_fasta(fa, refs["t"])
    assert p0.num_distinct and p1.num_distinct
    assert p0.num_distinct + p1.num_distinct == ref.num_distinct
    assert p0.merge(p1) == ref

    # the CLI on two processes: process 0 prints kmer_tpu's bytes
    argv = ["count", fa, "-k", "21", "--canonical", "--batch-reads", "8",
            "--max-read-len", "96"]
    rc, want, _ = _tsv(jax_main, argv, capsys)
    assert rc == 0 and want
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_pair([[sys.executable, "-m", "kmer_tpu_torch"] + argv + [
        "--multihost", "--coordinator", coord, "--num-processes", "2",
        "--process-id", str(pid), "--device", "cpu"] for pid in range(2)])
    assert outs[0].decode() == want
    assert outs[1] == b""
