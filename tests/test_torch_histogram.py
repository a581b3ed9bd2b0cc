"""Kernel K5's grid plan, its plain version on hot-bin and skewed
streams, and the port's independence from the kmer_tpu package.

- `histogram.plan` over lanes x bits x SM counts: every bin has exactly
  one owner block (`histogram.owner`, the kernel's layout), a block's
  bins fit its shared memory, the cluster stays within the portable 8, a
  cluster's lanes x 127 stay below 2**31 (int32 bins cannot overflow),
  the chunks cover the lanes, the grid holds one block an SM, and the
  flush (each cluster's non-zero bins) stays at most the lanes; MODE 3's
  lane hand-out (one lane a thread, a warp on consecutive lanes) on that
  grid takes every lane once;
- index_histogram_ref against kmer_tpu's Pallas K5 in interpret mode
  (exact: integer histograms) on streams whose valid lanes all fall in
  one bin, all in the last bin, or on a few hot bins;
- no file that the port builds or imports lies under kmer_tpu/.
The CUDA kernel is held against the plain version in test_torch_cuda.py.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops.pallas.histogram import index_histogram_mxu
import kmer_tpu_torch
from kmer_tpu_torch.io import fasta
from kmer_tpu_torch.ops.kernels import histogram as hk
from kmer_tpu_torch.pipeline import nativeagg
from kmer_tpu_torch.utils import build

PORT = os.path.dirname(os.path.abspath(kmer_tpu_torch.__file__))
REPO = os.path.dirname(PORT)
KMER_TPU = os.path.join(REPO, "kmer_tpu")

# 0, 1, the edges of a group of 16 lanes, a 2048-read and an 8192-read
# batch of k = 21 lanes (140 a read at L = 160), and 2**24
LANE_COUNTS = [0, 1, 15, 16, 17, 2048 * 140, 8192 * 140, 1 << 24]


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("bits", range(1, 17))
@pytest.mark.parametrize("n", LANE_COUNTS)
def test_plan(n, bits, sm_count):
    p = hk.plan(n, bits, sm_count)
    log_c = p.cluster.bit_length() - 1
    assert p.cluster in (1, 2, 4, 8) and bits >= 2 * log_c
    assert p.smem == (1 << bits) // p.cluster * 4 <= 227 * 1024
    # every bin has exactly one (block, bin in it), and the flush's map
    # from a block's bins back to the histogram's is its inverse
    rank, at = hk.owner(np.arange(1 << bits), bits, p.cluster)
    assert 0 <= rank.min() and rank.max() < p.cluster
    assert 0 <= at.min() and at.max() < p.smem // 4
    assert len(np.unique(rank * (p.smem // 4) + at)) == 1 << bits
    # the chunks cover the lanes, each cluster has some, and a cluster's
    # lanes (its chunk and < 32 unaligned ones) x 127 < 2**31
    assert p.chunk % hk.LANES == 0 and p.clusters >= 1
    assert p.clusters * p.chunk >= n
    assert n == 0 or (p.clusters - 1) * p.chunk < n
    assert (p.chunk + 32) * 127 < 1 << 31
    # one block an SM (fewer where the lanes are few), unless the int32
    # bins need more clusters
    assert (p.clusters * p.cluster <= max(sm_count, p.cluster)
            or p.clusters == -(-n // hk.MAX_CLUSTER_LANES))
    # the flush adds each block's non-zero bins: at most its cluster's
    # lanes, so at most the lanes (the kernel's partition modelled on
    # random indices)
    if 0 < n <= 8192 * 140:
        rng = np.random.default_rng(n + bits)
        idx = rng.integers(0, 1 << bits, n)
        flushed = len(np.unique((np.arange(n) // p.chunk << bits) + idx))
        assert flushed <= min(n, p.clusters << bits)


@pytest.mark.parametrize("bits", range(1, 17))
def test_plan_fills_the_card(bits):
    """With lanes to spare, one block on every SM."""
    p = hk.plan(1 << 24, bits, 132)
    assert p.clusters * p.cluster == 132


def test_plan_keeps_int32_bins_below_overflow():
    """One SM and more lanes than one cluster may take: the plan splits
    the lanes, whatever the card's fill."""
    n = 3 * hk.MAX_CLUSTER_LANES + 5
    p = hk.plan(n, 16, 1)
    assert p.clusters >= 4 and (p.chunk + 32) * 128 < 1 << 31


@pytest.mark.parametrize("bits", [15, 16])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 2048 * 60, 8192 * 140])
def test_plane_mode_lanes(n, bits):
    """MODE 3's hand-out (csrc/histogram.cu plane_lanes) on the plan's
    grid: block `rank` of cluster g takes lanes g chunk + rank THREADS +
    t, then steps of THREADS x cluster, below min(g chunk + chunk, n):
    every lane once, with no head or tail, and a warp's 32 threads on 32
    consecutive lanes."""
    p = hk.plan(n, bits, 132)
    seen = np.zeros(n, np.int64)
    step = hk.THREADS * p.cluster
    for g in range(p.clusters):
        lo, hi = g * p.chunk, min(g * p.chunk + p.chunk, n)
        for rank in range(p.cluster):
            first = lo + rank * hk.THREADS + np.arange(hk.THREADS)
            for m in range(-(-(hi - lo) // step)):
                i = first + m * step
                warps = i.reshape(-1, 32)
                assert (np.diff(warps, axis=1) == 1).all()
                i = i[i < hi]
                np.add.at(seen, i, 1)
    assert (seen == 1).all()


def _streams(bits, n, rng):
    """name -> indices: every lane in one bin, every lane in the last
    bin, and four hot bins holding nearly every lane."""
    top = (1 << bits) - 1
    hot = rng.choice(1 << bits, 4, replace=False)
    skewed = np.where(rng.random(n) < 0.98, hot[rng.integers(0, 4, n)],
                      rng.integers(0, 1 << bits, n))
    return {"one_bin": np.full(n, int(rng.integers(0, top))),
            "last_bin": np.full(n, top), "skewed": skewed}


@pytest.mark.parametrize("stream", ["one_bin", "last_bin", "skewed"])
@pytest.mark.parametrize("bits", [15, 16])
def test_k5_plain_equals_pallas_on_hot_bins(bits, stream):
    rng = np.random.default_rng(bits)
    n = 6000
    idx = _streams(bits, n, rng)[stream]
    valid = rng.random(n) < 0.9
    want = index_histogram_mxu(jnp.asarray(idx, jnp.int32),
                               jnp.asarray(valid), bits, interpret=True)
    got = hk.index_histogram(torch.from_numpy(idx),
                             torch.from_numpy(valid.astype(np.int8)), bits)
    np.testing.assert_array_equal(got.numpy(), hk.histogram_from_tpu(want))
    assert int(got.sum()) == int(valid.sum())
    if stream != "skewed":
        assert int(got[int(idx[0])]) == int(valid.sum())


def _port_files():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_names_no_kmer_tpu_path_or_module():
    """No module of the port (nor chip_smoke.py) imports kmer_tpu, names
    KMER_TPU_DIR, or hands build_cdll anything but its own csrc/ or
    native/ sources."""
    for path in _port_files():
        src = open(path).read()
        assert "KMER_TPU_DIR" not in src, path
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                names = []
            assert not any(m == "kmer_tpu" or m.startswith("kmer_tpu.")
                           for m in names), (path, names)
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "build_cdll"):
                used = {n.id for n in ast.walk(node.args[0])
                        if isinstance(n, ast.Name)}
                assert used & {"CSRC_DIR", "NATIVE_DIR"}, (path, used)
                assert not any(isinstance(n, ast.Constant)
                               and "kmer_tpu/" in str(n.value)
                               for n in ast.walk(node.args[0])), path


def test_parallel_and_chip_smoke_import_neither_jax_nor_kmer_tpu():
    """kmer_tpu_torch/parallel/ (mesh, comm, halo, distributed, multihost)
    and chip_smoke.py import nothing of jax or kmer_tpu: no import
    statement names them, and a fresh interpreter that imports every
    parallel module and chip_smoke holds neither."""
    import subprocess
    import sys
    par = os.path.join(PORT, "parallel")
    mods = sorted(f[:-3] for f in os.listdir(par) if f.endswith(".py"))
    assert {"mesh", "comm", "halo", "distributed", "multihost"} <= set(mods)
    for path in [os.path.join(par, f"{m}.py") for m in mods] + [
            os.path.join(REPO, "chip_smoke.py")]:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("jax", "kmer_tpu")
                           for n in names), (path, names)
    code = ("import sys\n"
            + "".join(f"import kmer_tpu_torch.parallel.{m}\n"
                      for m in mods if m != "__init__")
            + "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'kmer_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]


class _Built(Exception):
    """Raised by the stand-in build_cdll once it has seen a source."""


def test_port_builds_only_its_own_sources(monkeypatch):
    """Every loader hands build_cdll a source inside kmer_tpu_torch/ (the
    host C++ from its own native/ copy), none under kmer_tpu/."""
    from kmer_tpu_torch.ops.kernels import (compact, extract, fused_extract,
                                            fused_gapped, grouped_count,
                                            sort)
    seen = []

    def record(src, name, **kw):
        seen.append(os.path.abspath(src))
        raise _Built

    monkeypatch.setattr(build, "build_cdll", record)
    mods = (fasta, nativeagg, compact, extract, fused_extract, fused_gapped,
            grouped_count, hk, sort)
    for mod in mods:
        monkeypatch.setattr(mod, "_lib", None)
    for load in (fasta.load_native, nativeagg.load, compact.load,
                 extract.load, fused_extract.load, fused_gapped.load,
                 grouped_count.load, hk.load, sort.load):
        with pytest.raises(_Built):
            load()
    assert len(seen) == len(mods)
    for src in seen:
        assert os.path.exists(src), src
        assert src.startswith(PORT + os.sep), src
        assert not src.startswith(KMER_TPU + os.sep), src
    assert {os.path.relpath(s, PORT) for s in seen} >= {
        os.path.join("native", "fasta_pack.cpp"),
        os.path.join("native", "aggregate.cpp")}
