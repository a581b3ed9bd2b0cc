"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  Phases, each printing one line (or a
few) to stdout:

  1. environment: torch/CUDA versions, the card's name and power limit,
     nvcc, the native host libraries and the kernel build time;
  2. kernel K1 (kmer_tpu_torch/csrc/fused_extract.cu) against its plain
     torch version on the card, bit-exact lane for lane, at the main
     path's shape (B=8192, L=160, k=21, canonical, seg=2, packed rows)
     and at edge cases; both timed on the device with CUDA events (the
     median of 20 samples of 10 back-to-back calls, after warm-up), and
     as a caller sees one synchronised call;
  3. end to end through kmer_tpu_torch.count_fasta(..., device="cuda"),
     k=21, canonical, the default KmerConfig, on a seeded E. coli-sized
     corpus (1M reads of 150 bases from a 4.6 Mbase genome, 0.2% base
     errors, ~32x coverage): the table total, the kernel's launch count
     against the batch count, and an independent numpy oracle on the
     first 50,000 reads;
  4. one JSON line with every kernel of the path, then the result line
     {"ok": true, "device": {...}} last.

Any failed check raises, so the script exits non-zero and prints no
result line.  Without a CUDA device it fails at once.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 21
MAIN_B, MAIN_L, SEG = 8192, 160, 2
N_READS, READ_LEN, GENOME_LEN, ERROR_RATE = 1_000_000, 150, 4_600_000, 0.002
ORACLE_READS = 50_000


def _say(*parts) -> None:
    print(*parts, flush=True)


def _tool(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout.strip()


def kernel_batch(rng, B, L, k, *, packed, amb, short):
    """Random codes + lengths + limits as tensors (host side); packed
    rows cross as the int32 view of the 2-bit packed words."""
    from kmer_tpu_torch.io.fasta import pack_batch_codes
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    if short:
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        limits = rng.integers(1, L + 1, B).astype(np.int32)
    else:                       # full 150-base reads, as the main path
        lengths = np.full(B, min(READ_LEN, L), np.int32)
        limits = np.full(B, L, np.int32)
    c = pack_batch_codes(codes).view(np.int32) if packed else codes
    return [torch.from_numpy(np.ascontiguousarray(c)),
            torch.from_numpy(lengths), torch.from_numpy(limits)]


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call: the median over `reps` samples, each the
    CUDA-event time of `inner` back-to-back calls divided by `inner`,
    after warm-up.  A sleep kernel queued ahead of each sample holds the
    stream while the host enqueues the calls, so the events time device
    work alone, not the host's per-call launch cost."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)        # ~30 ms of GPU cycles
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return float(np.median(ts))


def time_host_ms(fn, reps: int = 20) -> float:
    """Median wall time of one synchronised call, as a caller sees it
    (host launch cost included)."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_kernel(dev, seed: int) -> dict:
    """Kernel == plain version, lane for lane, on `dev`; returns the
    kernel's JSON record (without the main-path launch count)."""
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    rng = np.random.default_rng(seed)
    cases = [  # (B, L, k, canonical, packed, ambiguous, short, seg)
        (MAIN_B, MAIN_L, K, True, True, False, False, SEG),
        (4096, 150, 5, True, True, False, True, 2),
        (4096, 150, 15, True, True, False, True, 8),
        (4096, 150, 16, True, True, False, True, 2),
        (4096, 150, 31, True, True, False, True, 4),
        (4096, 150, 21, False, True, False, True, 2),
        (4096, 150, 21, True, False, True, True, 2),
        (999, 77, 31, False, False, True, True, 16),
    ]
    max_err = 0
    for B, L, k, canon, packed, amb, short, seg in cases:
        host = kernel_batch(rng, B, L, k, packed=packed, amb=amb,
                            short=short)
        kw = dict(canonical=canon, mask_ambiguous=amb, seg=seg,
                  packed_width=L if packed else 0)
        on_dev = [t.to(dev) for t in host]
        keys, counts = fe.fused_extract_count(*on_dev, k, **kw)
        want_keys, want_counts = fe.fused_extract_count_ref(*on_dev, k, **kw)
        torch.cuda.synchronize()
        err = max(int((keys - want_keys).abs().max()),
                  int((counts.to(torch.int32)
                       - want_counts.to(torch.int32)).abs().max()))
        live = int((counts > 0).sum())
        _say(f"kernel_check B={B} L={L} k={k} canonical={canon} "
             f"packed={packed} ambiguous={amb} short={short} seg={seg} "
             f"live_lanes={live} max_abs_err={err}")
        if err != 0 or live == 0:
            raise AssertionError(f"kernel != plain version (k={k}, "
                                 f"max_abs_err={err}, live={live})")
        max_err = max(max_err, err)
    main = [t.to(dev) for t in kernel_batch(rng, MAIN_B, MAIN_L, K,
                                            packed=True, amb=False,
                                            short=False)]
    kw = dict(canonical=True, seg=SEG, packed_width=MAIN_L)
    kernel = functools.partial(fe.fused_extract_count, *main, K, **kw)
    plain = functools.partial(fe.fused_extract_count_ref, *main, K, **kw)
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    host_ms, plain_host_ms = time_host_ms(kernel), time_host_ms(plain)
    lanes = (MAIN_L - K + 1) * MAIN_B
    out_bytes = lanes * 9
    _say(f"kernel_time B={MAIN_B} L={MAIN_L} k={K} kernel_ms={ms} "
         f"plain_ms={plain_ms} speedup={plain_ms / ms} "
         f"lanes_per_s={lanes / (ms * 1e-3)} "
         f"out_GB_per_s={out_bytes / (ms * 1e-3) / 1e9} "
         f"kernel_call_ms={host_ms} plain_call_ms={plain_host_ms} "
         f"(tolerance: exact, max_abs_err must be 0)")
    return {"name": "fused_extract_count", "route": "cuda",
            "source": fe.SOURCE, "replaces": fe.REPLACES,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def oracle_table(path: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counts of an equal-length-read FASTA by sliding
    windows + np.unique: (sorted uint64 key values, counts)."""
    lut = np.full(256, 255, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    seqs = [ln for ln in lines if ln and not ln.startswith(b">")]
    codes = lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(
        len(seqs), -1).astype(np.int64)
    if codes.max() > 3:
        raise ValueError(f"{path}: oracle takes A/C/G/T reads only")
    win = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)
    win = win.reshape(-1, k)
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    fwd = win @ pw
    rc = (3 - win[:, ::-1]) @ pw
    vals, counts = np.unique(np.minimum(fwd, rc), return_counts=True)
    return vals.astype(np.uint64), counts.astype(np.int64)


def table_values(table) -> np.ndarray:
    """KmerTable (M, W<=2) uint32 key words -> (M,) uint64 values."""
    v = table.keys[:, 0].astype(np.uint64)
    if table.keys.shape[1] == 2:
        v = (v << np.uint64(32)) | table.keys[:, 1].astype(np.uint64)
    return v


def phase_end_to_end(dev, seed: int, tmp: str, n_reads: int = N_READS,
                     genome_len: int = GENOME_LEN,
                     oracle_reads: int = ORACLE_READS) -> int:
    """count_fasta on `dev` at the main path's configuration; returns the
    kernel launches counted in the timed run."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.generator import genome_reads_fasta
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.utils import stagetime
    t0 = time.perf_counter()
    text = genome_reads_fasta(n_reads, READ_LEN, genome_len=genome_len,
                              seed=seed, error_rate=ERROR_RATE)
    path = os.path.join(tmp, "corpus.fasta")
    with open(path, "w") as f:
        f.write(text)
    lines = text.split("\n", 2 * oracle_reads)
    small = os.path.join(tmp, "oracle.fasta")
    with open(small, "w") as f:
        f.write("\n".join(lines[:2 * oracle_reads]) + "\n")
    del text, lines
    _say(f"corpus reads={n_reads} read_len={READ_LEN} "
         f"genome_len={genome_len} error_rate={ERROR_RATE} seed={seed} "
         f"bytes={os.path.getsize(path)} "
         f"make_s={time.perf_counter() - t0}")

    cfg = KmerConfig(k=K, canonical=True)
    # oracle check (also warms the pinned-memory pool and the allocator)
    want_v, want_c = oracle_table(small, K)
    got = count_fasta(small, cfg, device=dev)
    if not (np.array_equal(table_values(got), want_v)
            and np.array_equal(got.counts, want_c)):
        raise AssertionError("count_fasta != numpy oracle on the first "
                             f"{oracle_reads} reads")
    _say(f"oracle_check reads={oracle_reads} distinct={got.num_distinct} "
         f"total={got.total} equal=True")

    # the timed main-path run; a single ingest chunk holds every read
    if os.path.getsize(path) > cfg.ingest_chunk_bases:
        raise AssertionError("corpus spans several ingest chunks")
    want_batches = -(-n_reads // cfg.batch_reads)
    times: dict[str, float] = {}
    torch.cuda.synchronize()
    fe.launches = 0
    with stagetime.collect(times):
        table = count_fasta(path, cfg, device=dev)
    launches = fe.launches
    total_kmers = n_reads * (READ_LEN - K + 1)
    if table.total != total_kmers:
        raise AssertionError(f"table total {table.total} != "
                             f"sum(len - k + 1) = {total_kmers}")
    if launches != want_batches:
        raise AssertionError(f"K1 launches {launches} != batches "
                             f"{want_batches}")
    if not (np.all(np.diff(table_values(table)) > 0)
            and table.counts.min() > 0):
        raise AssertionError("table keys not sorted-unique / counts <= 0")
    wall = times["total"]
    _say(f"end_to_end reads={n_reads} kmers={total_kmers} "
         f"distinct={table.num_distinct} batches={want_batches} "
         f"k1_launches={launches} wall_s={wall} "
         f"reads_per_s={n_reads / wall} kmers_per_s={total_kmers / wall}")
    _say("stages_s " + json.dumps(times, sort_keys=True))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # phase 1: environment and builds
    from kmer_tpu_torch.io import fasta
    from kmer_tpu_torch.ops.kernels import fused_extract as fe
    from kmer_tpu_torch.pipeline import nativeagg
    from kmer_tpu_torch.utils import build
    _say(f"python={sys.version.split()[0]} torch={torch.__version__} "
         f"cuda={torch.version.cuda} devices={torch.cuda.device_count()}")
    _say(_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0])
    _say("nvcc: " + _tool([build.nvcc(), "--version"]).splitlines()[-1])
    fe.load()
    fasta.load_native()
    nativeagg.load()
    _say(f"native_parser_loaded={fasta.native_loaded()} "
         f"native_aggregator_loaded={nativeagg.native_loaded()} "
         f"build_s={json.dumps(build.build_seconds, sort_keys=True)}")

    # phase 2: kernel against its plain version
    record = phase_kernel(dev, args.seed)

    # phase 3: the main path end to end
    with tempfile.TemporaryDirectory() as tmp:
        record["launches"] = phase_end_to_end(dev, args.seed, tmp)

    _say(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
