"""A/B of kernel K7's multi-word body (kmer_tpu_torch/csrc/extract.cu,
keys of more than 63 bases) against another tree's on one card.

    PYTHONPATH=. python scripts/ab_extract.py OTHER_CSRC_DIR [VARIANT.cu ...]
        [--floor] [--walls]

Builds this tree's extract.cu, OTHER_CSRC_DIR/extract.cu and each VARIANT
source with the port's nvcc flags (sm_90a; `build` of
scripts/ab_histogram.py) into a temporary directory, checks every build
against the plain version (`extract_keys_ref`) at every shape, bit for
bit (but a variant named t_*.cu, a floor timed only), then times them
with CUDA events in turns (other, this, this, other, then each variant
twice) and prints one line a shape: each build's
smaller reading and the plain version's, ms, with this tree's launch
(body, outputs a thread, blocks, registers).  --floor adds a store
floor, timed only: this tree's body with every lane invalid (it stages
the rows, steps through its outputs and stores sentinels, but cuts
nothing).  The shapes: canonical keys
of k = 64, 101 and 130 (3, 4 and 5 words) from packed rows of L = 160
with full 150-base reads, at the main path's batch of 8192 reads and at
`card`'s of 2048, seeded with numpy; each is also checked, not timed, on
u8 rows with ambiguous codes, short rows and limits, not canonical.
--walls then builds this tree's and OTHER_CSRC_DIR's histogram.cu (K5)
as well and runs `card -k 101 --canonical` (sketch_histograms at
`card`'s batch of 2048 reads) on chip_smoke.py's 1M-read corpus with each
tree's K7 and K5 in turns (other, this, this, other, after a warm-up
run with each), every histogram equal to the first; one line with the
walls (s).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ab_histogram import bind as bind_histogram
from ab_histogram import build
from chip_smoke import time_ms
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import histogram as hk

L, READ_LEN = 160, 150
# (name, reads, k)
SHAPES = [(f"{name}_k{k}", B, k) for k in (64, 101, 130)
          for name, B in (("batch", 8192), ("card", 2048))]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare a K7 library's multi-word launch entry (a build of this
    tree's, or of one before the tile body, whose entry is the same)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.extract_wide_launch.restype = i
    lib.extract_wide_launch.argtypes = [vp, i, i, vp, vp, vp] + [i] * 6 + [
        vp]
    return lib


def launch(lib, codes, lengths, limits, k: int, canonical: bool,
           packed: bool, amb: bool):
    """One multi-word launch of `lib` into a fresh (W, B, P) buffer."""
    W, B, P = ek.words64(k), codes.shape[0], L - k + 1
    out = torch.empty((W, B, P), dtype=torch.int64, device=codes.device)
    rc = lib.extract_wide_launch(
        codes.data_ptr(), int(packed), codes.shape[1], lengths.data_ptr(),
        limits.data_ptr(), out.data_ptr(), B, L, k, W, int(canonical),
        int(amb), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return tuple(out)


def batch(rng, B: int, k: int, *, packed: bool, short: bool, dev):
    """(codes, lengths, limits) on dev: packed rows of full reads, or u8
    rows with a twentieth of the codes ambiguous and random lengths and
    limits."""
    from kmer_tpu_torch.io.fasta import pack_batch_codes
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if short:
        codes[rng.random((B, L)) < 0.05] = 4
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        limits = rng.integers(1, L + 1, B).astype(np.int32)
    else:
        lengths = np.full(B, READ_LEN, np.int32)
        limits = np.full(B, L, np.int32)
    c = pack_batch_codes(codes).view(np.int32) if packed else codes
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (c, lengths, limits)]


# this tree's tile body with every lane invalid: its store floor
FLOOR_OLD = """    bool ok = o < o_hi[s];
    if (amb && ok) ok = !span_ambiguous(f + cap, q, n);
"""
FLOOR_NEW = "    bool ok = false;\n"


def floor_source(here: str, out_dir: str) -> str:
    """The store floor's source beside a copy of kmer_window.cuh."""
    with open(here) as f:
        text = f.read()
    if FLOOR_OLD not in text:
        raise RuntimeError("extract.cu's tile body changed: no floor")
    dst = os.path.join(out_dir, "t_floor.cu")
    with open(dst, "w") as f:
        f.write(text.replace(FLOOR_OLD, FLOOR_NEW))
    shutil.copy(os.path.join(os.path.dirname(here), "kmer_window.cuh"),
                out_dir)
    return dst


def check(libs, rng, dev) -> None:
    """Every build equals the plain version at every shape, bit for bit,
    on packed full rows (canonical) and u8 short rows (not canonical,
    ambiguity mask)."""
    for name, B, k in SHAPES:
        for packed, canon in ((True, True), (False, False)):
            args = batch(rng, B, k, packed=packed, short=not packed, dev=dev)
            want = ek.extract_keys_ref(*args, k, canonical=canon,
                                       mask_ambiguous=not packed,
                                       packed_width=L if packed else 0)
            for m, lib in libs.items():
                if m.startswith("t_"):
                    continue
                got = launch(lib, *args, k, canon, packed, not packed)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{m} != plain version at {name} "
                                         f"packed={packed}")
    print(f"k7_ab check shapes={len(SHAPES)} builds={list(libs)} "
          "equal=True", flush=True)


def walls(libs, hist_libs) -> None:
    """`card -k 101` on chip_smoke.py's corpus with each tree's K7 and K5
    in turns."""
    import chip_smoke as cs
    from kmer_tpu_torch import KmerConfig
    from kmer_tpu_torch.io.generator import genome_reads_fasta
    from kmer_tpu_torch.pipeline.sketch import sketch_histograms
    cs.build_all()
    real = ek._lib, hk._lib
    cfg = KmerConfig(k=cs.ANY_K, canonical=True, batch_reads=cs.CARD_B)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fasta")
        with open(path, "w") as f:
            f.write(genome_reads_fasta(cs.N_READS, cs.READ_LEN,
                                       genome_len=cs.GENOME_LEN, seed=0,
                                       error_rate=cs.ERROR_RATE))
        first, got = None, {}
        try:
            # a warm-up run with each tree's kernels (their modules load at
            # first launch), then the timed turns
            for run, m in enumerate(("this", "other", "other", "this",
                                     "this", "other")):
                ek._lib, hk._lib = libs[m], hist_libs[m]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hists, totals = sketch_histograms(path, [cs.ANY_K], cfg,
                                                  device="cuda")
                wall = time.perf_counter() - t0
                if first is None:
                    first = hists[cs.ANY_K]
                if not np.array_equal(hists[cs.ANY_K], first):
                    raise AssertionError(f"{m}'s card histogram differs")
                if run >= 2:
                    got.setdefault(m, []).append(wall)
        finally:
            ek._lib, hk._lib = real
    print(f"k7_k5_wall run=card_k{cs.ANY_K} reads={cs.N_READS} "
          f"total={totals[cs.ANY_K]} "
          + " ".join(f"{m}_wall_s={min(t)} ({', '.join(map(str, t))})"
                     for m, t in got.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other tree's kmer_tpu_torch/csrc")
    ap.add_argument("variants", nargs="*", help="more extract.cu sources")
    ap.add_argument("--floor", action="store_true",
                    help="also time this tree's body storing sentinels only")
    ap.add_argument("--walls", action="store_true",
                    help="`card -k 101`'s wall with each tree's K7 and K5")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    csrc = os.path.join(os.path.dirname(os.path.abspath(ek.__file__)),
                        "..", "..", "csrc")
    srcs = {"other": os.path.join(args.other, "extract.cu"),
            "this": os.path.join(csrc, "extract.cu")}
    srcs.update({os.path.basename(v): v for v in args.variants})
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        if args.floor:
            srcs["t_floor"] = floor_source(srcs["this"], tmp)
        libs = {m: bind(build(src, tmp, f"k7_{i}"))
                for i, (m, src) in enumerate(srcs.items())}
        check(libs, rng, dev)
        for name, B, k in SHAPES:
            args_ = batch(rng, B, k, packed=True, short=False, dev=dev)
            fns = {m: functools.partial(launch, lib, *args_, k, True, True,
                                        False) for m, lib in libs.items()}
            order = ["other", "this", "this", "other"]
            order += [m for m in fns if m not in ("other", "this")
                      for _ in range(2)]
            times: dict[str, list[float]] = {}
            for m in order:
                times.setdefault(m, []).append(time_ms(fns[m]))
            plain_ms = time_ms(functools.partial(
                ek.extract_keys_ref, *args_, k, canonical=True,
                packed_width=L), reps=3, inner=1)
            info = ek.launch_info(B, L, k, canonical=True)
            print(f"k7_ab shape={name} B={B} L={L} k={k} W={ek.words64(k)} "
                  f"lanes={B * (L - k + 1)} "
                  + " ".join(f"{m}_ms={min(t)} ({', '.join(map(str, t))})"
                             for m, t in times.items())
                  + f" plain_ms={plain_ms} launch=" + " ".join(
                      f"{key}={v}" for key, v in info.items()), flush=True)
        if args.walls:
            hist_libs = {m: bind_histogram(build(
                os.path.join(os.path.dirname(srcs[m]), "histogram.cu"),
                tmp, f"k5_{m}")) for m in ("other", "this")}
            walls(libs, hist_libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
