"""utils/profiling of the port against kmer_tpu's on the CPU: trace()
and `--profile-dir`, Roofline's byte counts, and detect_hbm_bw, which
knows no bandwidth off the card."""

import glob
import json
import os

import pytest
import torch

from kmer_tpu.cli import main as jax_main
from kmer_tpu.utils import profiling as jprof
from kmer_tpu_torch.cli import main as port_main
from kmer_tpu_torch.io.generator import genome_reads_fasta
from kmer_tpu_torch.utils import profiling


def _trace_files(d):
    return glob.glob(os.path.join(str(d), "*.pt.trace.json"))


def test_trace_none_is_a_no_op(tmp_path):
    with profiling.trace(None):
        x = torch.arange(10).sum()
    with profiling.trace(""):
        x += 1
    assert int(x) == 46 and os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "a" / "b"                     # made if needed
    with profiling.trace(str(d)):
        torch.sort(torch.arange(1000, 0, -1))
    [f] = _trace_files(d)
    with open(f) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("sort" in n for n in names), sorted(names)[:20]


@pytest.mark.parametrize("B,L,k,W", [(8192, 160, 21, 2), (256, 416, 55, 4),
                                     (1, 31, 31, 2), (2048, 150, 5, 1)])
def test_roofline_bytes_match(B, L, k, W):
    for name in ("for_sort_step", "for_fused_step"):
        got = getattr(profiling.Roofline, name)(B, L, k, W)
        want = getattr(jprof.Roofline, name)(B, L, k, W)
        assert (got.batch_bytes, got.key_bytes, got.out_bytes,
                got.total_bytes) == (want.batch_bytes, want.key_bytes,
                                     want.out_bytes, want.total_bytes)
        assert got.fraction(1e-3, 2e12) == want.fraction(1e-3, 2e12)
    got = profiling.Roofline.for_fused_step(B, L, k, W, cnt_bytes=1)
    assert got.total_bytes == jprof.Roofline.for_fused_step(
        B, L, k, W, cnt_bytes=1).total_bytes
    if k <= 12:
        assert profiling.Roofline.for_dense_step(B, L, k).total_bytes == \
            jprof.Roofline.for_dense_step(B, L, k).total_bytes


def test_bandwidth_unknown_off_the_card(monkeypatch):
    r = profiling.Roofline.for_fused_step(8192, 160, 21, 2)
    if not torch.cuda.is_available():
        assert profiling.detect_hbm_bw() is None
        with pytest.raises(ValueError, match="bandwidth unknown"):
            r.fraction(1e-3)
        with pytest.raises(ValueError, match="bandwidth unknown"):
            r.seconds_at_roofline()
    assert profiling.detect_hbm_bw("cpu") is None
    assert r.seconds_at_roofline(3.35e12) == r.total_bytes / 3.35e12
    # by the card's name: the H100's figure, None for another card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name, bw in (("NVIDIA H100 80GB HBM3", 3.35e12),
                     ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, _n=name: _n)
        assert profiling.detect_hbm_bw() == bw
        assert profiling.detect_hbm_bw("cuda:0") == bw
        if bw is None:
            with pytest.raises(ValueError, match="bandwidth unknown"):
                r.fraction(1e-3)
        else:
            assert r.seconds_at_roofline() == r.total_bytes / bw


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    p = tmp_path_factory.mktemp("prof") / "r.fasta"
    p.write_text(genome_reads_fasta(200, 100, genome_len=2000, seed=6))
    return str(p)


@pytest.mark.parametrize("two_pass", [False, True])
def test_cli_profile_dir(reads, tmp_path, capsys, two_pass):
    """count --profile-dir writes a trace and the same TSV as without."""
    args = ["count", reads, "-k", "17", "--canonical", "--batch-reads", "32",
            "--max-read-len", "128", "--device", "cpu"]
    if two_pass:
        args += ["--two-pass", "--partitions", "3", "--spill-dir"]
    plain = args + ([str(tmp_path / "s1")] if two_pass else [])
    assert port_main(plain) == 0
    want = capsys.readouterr().out
    prof = str(tmp_path / "prof")
    traced = args + ([str(tmp_path / "s2")] if two_pass else [])
    assert port_main(traced + ["--profile-dir", prof]) == 0
    assert capsys.readouterr().out == want and want.count("\n") > 100
    [f] = _trace_files(prof)
    with open(f) as fh:
        assert json.load(fh)["traceEvents"]
    ref = [a for a in plain if a not in ("--device", "cpu")]
    if two_pass:
        ref[-1] = str(tmp_path / "s3")
    assert jax_main(ref) == 0
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("cmd", [["histo", "-k", "17"], ["card", "-k", "17"]])
def test_histo_and_card_ignore_profile_dir(reads, tmp_path, capsys,
                                          monkeypatch, cmd):
    monkeypatch.setenv("KMER_TPU_PARSE_THREADS", "1")   # restored after
    args = [cmd[0], reads, *cmd[1:], "--max-read-len", "128"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    prof = tmp_path / "prof"
    assert port_main(args + ["--profile-dir", str(prof), "--threads", "2",
                             "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and not prof.exists()
