"""A/B of kernel K6 (kmer_tpu_torch/csrc/sort.cu) against another tree's
on one card.

    PYTHONPATH=. python scripts/ab_sort.py OTHER_CSRC_DIR [VARIANT.cu ...]
        [--shapes REGEX] [--profile] [--walls]

Builds this tree's sort.cu, OTHER_CSRC_DIR/sort.cu and each VARIANT
source with the port's nvcc flags (sm_90a) into a temporary directory,
checks every build against the plain version (`sort_words_ref`) at every
shape, bit for bit, payload order included, then times them with CUDA
events in turns (other, this, this, other, then each variant twice) and
prints one line a shape: each build's smaller reading, the plain
version's and one `torch.sort` of key word 0 (the library yardstick),
ms.  --profile adds, for this tree's build, one call's device time by
kernel (torch.profiler).  The shapes, made on the card from a seed, are
the callers' (chip_smoke.py builds the same from the kernels' output):
the k = 21, k = 55 and k = 101 device merges (a sorted unique state,
half of it sentinel padding, and a batch with dead lanes; the counts as
payload), the parity dump's (hi, lo, count) rows, the k = 63 lo words of
one batch and the mesh's owner partition of one k = 21 batch.  --walls
then runs the device merge end to end (`count_fasta(...,
device_merge="on")`, the port's own pipeline with K6 swapped for each
build) in the same turns on chip_smoke.py's corpora: k = 21, 55 and 101
on its 1M reads, gapped 27/27 on its 4000 records; every table must
equal the first, and each line gives the walls and the STAGES (s).  A
build with `sort_plan` takes the key bits in its scratch size; one
without takes (W, n), as the kernel's entry did before the MSD design.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import re
import subprocess
import sys
import tempfile

import torch

from chip_smoke import device_kernel_ms, time_ms
from kmer_tpu_torch.ops.kernels import sort as sk
from kmer_tpu_torch.utils.build import NVCCFLAGS, nvcc

# the stages a device-merge wall line gives beside the wall
STAGES = ("dispatch", "device_sync", "readback", "host_merge")
# (name, rows, key bits, payload planes, state share of the rows)
SHAPES = [("k21_merge", 25_165_824, (42,), 1, 2 / 3),
          ("k55_merge", 25_165_824, (62, 48), 1, 2 / 3),
          ("k101_merge", 12_582_912, (62, 62, 62, 16), 1, 2 / 3),
          ("parity", 4_500_000, (54, 54, 31), 0, 0),
          ("k63_lo", 802_816, (62, 64), 1, 0),
          ("owner_partition", 1_146_880, (3,), 2, 0)]


def build(src: str, out_dir: str, name: str) -> ctypes.CDLL:
    so = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc(), *NVCCFLAGS, "-shared", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sort_words_launch.restype = i
    lib.sort_words_launch.argtypes = [vp, i, i, vp, i64, vp, vp]
    lib.sort_scratch_words.restype = i64
    try:
        lib.sort_plan
        lib.bits_in_scratch = True
        lib.sort_scratch_words.argtypes = [i, i, vp, i64]
    except AttributeError:
        lib.bits_in_scratch = False
        lib.sort_scratch_words.argtypes = [i, i64]
    return lib


def launch(lib, words, bits) -> None:
    W, K, n = len(words), len(bits), words[0].numel()
    c_bits = (ctypes.c_int * K)(*bits)
    size = (lib.sort_scratch_words(W, K, c_bits, n) if lib.bits_in_scratch
            else lib.sort_scratch_words(W, n))
    scratch = torch.empty(size, dtype=torch.int64, device=words[0].device)
    ptrs = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
    rc = lib.sort_words_launch(ptrs, W, K, c_bits, n, scratch.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def _sort_with(lib, words, num_keys=None, bits=None):
    """ops/kernels/sort.sort_words with `lib`'s kernel on CUDA tensors."""
    words, num_keys, bits = sk._check(words, num_keys, bits)
    if words[0].device.type == "cpu":
        return sk.sort_words_ref(words, num_keys, bits)
    if words[0].numel():
        launch(lib, words, bits)
        sk.launches += 1
    return words


def _walls(m: str, t) -> str:
    """One build's smallest wall, then each run's wall and stages (s)."""
    return (f"{m}_wall_s={min(w for w, _ in t)} ("
            + "; ".join(f"{w} " + " ".join(f"{k}={v:.3f}"
                                           for k, v in st.items())
                        for w, st in t) + ")")


def walls(libs) -> None:
    """The device-merge runs end to end, each build's K6 in turns."""
    import chip_smoke as cs
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.generator import (genome_reads_fasta,
                                             reference_style_fasta)
    from kmer_tpu_torch.utils import stagetime
    cs.build_all()
    real = sk.sort_words
    with tempfile.TemporaryDirectory() as tmp:
        reads = os.path.join(tmp, "reads.fasta")
        with open(reads, "w") as f:
            f.write(genome_reads_fasta(cs.N_READS, cs.READ_LEN,
                                       genome_len=cs.GENOME_LEN, seed=0,
                                       error_rate=cs.ERROR_RATE))
        recs = os.path.join(tmp, "gapped.fasta")
        with open(recs, "w") as f:
            f.write(reference_style_fasta(n_records=cs.GAP_RECORDS, seed=0))
        runs = [("k21", reads, KmerConfig(k=cs.K, canonical=True)),
                ("k55", reads, KmerConfig(k=cs.WIDE_K, canonical=True)),
                ("k101", reads, KmerConfig(k=cs.ANY_K, canonical=True)),
                ("gapped", recs, KmerConfig(gapped=True, batch_reads=cs.GAP_B,
                                            max_read_len=512))]
        try:
            for name, path, cfg in runs:
                cfg = cfg.replace(device_merge="on")
                first, got = None, {}
                for m in ("other", "this", "this", "other"):
                    sk.sort_words = functools.partial(_sort_with, libs[m])
                    times: dict[str, float] = {}
                    with stagetime.collect(times):
                        table = count_fasta(path, cfg, device="cuda")
                    if first is None:
                        first = table
                    elif not table == first:
                        raise AssertionError(f"{m}'s {name} table differs")
                    got.setdefault(m, []).append(
                        (times["total"], {k: times.get(k, 0.0)
                                          for k in STAGES}))
                    del table
                print(f"k6_wall run={name} distinct={first.num_distinct} "
                      + " ".join(_walls(m, t) for m, t in got.items()),
                      flush=True)
                del first
        finally:
            sk.sort_words = real


def _kernel(key: str) -> str:
    """A profiler key's kernel name, without its namespace and arguments."""
    return key.replace("void ", "").replace("(anonymous namespace)::",
                                            "").split("(")[0]


def rows(name, n, bits, payload, state_share, gen, dev):
    """The shape's planes: key words, then payload planes."""
    S = sk.SENTINEL

    def rand(hi, m=n):
        return torch.randint(0, hi, (m,), generator=gen, device=dev)
    if name == "owner_partition":
        return [rand(4)] + [rand(1 << 42) for _ in range(payload)]
    n_state = int(n * state_share)
    if n_state:
        # a sorted unique state, half of it live, the rest sentinel padding
        state = sk.sort_words_ref([rand(1 << b, n_state // 2) for b in bits])
        keys = []
        for s_w, b in zip(state, bits):
            pad = torch.full((n_state - s_w.numel(),), S, device=dev)
            keys.append(torch.cat([s_w, pad, rand(1 << b, n - n_state)]))
    else:
        keys = [rand(1 << b if b < 64 else 1 << 62) - (0 if b < 64 else
                                                       1 << 61)
                for b in bits]
    dead = torch.rand(n, generator=gen, device=dev) < 0.1
    if n_state:
        dead[:n_state] = False
    keys = [torch.where(dead, S, k) if b < 64 else k
            for k, b in zip(keys, bits)]
    return keys + [rand(50) for _ in range(payload)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other tree's kmer_tpu_torch/csrc")
    ap.add_argument("variants", nargs="*", help="more sort.cu sources")
    ap.add_argument("--shapes", default=".", help="regex of shape names")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--walls", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    here = os.path.join(os.path.dirname(os.path.abspath(sk.__file__)),
                        "..", "..", "csrc", "sort.cu")
    srcs = {"other": os.path.join(args.other, "sort.cu"), "this": here}
    srcs.update({os.path.basename(v): v for v in args.variants})
    gen = torch.Generator(device=dev).manual_seed(6)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(src, tmp, f"k6_{i}")
                for i, (name, src) in enumerate(srcs.items())}
        for name, n, bits, payload, state_share in SHAPES:
            if not re.search(args.shapes, name):
                continue
            words = rows(name, n, bits, payload, state_share, gen, dev)
            want = sk.sort_words_ref(words, len(bits), bits)
            for lib_name, lib in libs.items():
                got = [w.clone() for w in words]
                launch(lib, got, bits)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{lib_name} != plain version at "
                                         f"{name}")
                del got
            del want
            order = ["other", "this", "this", "other"]
            order += [m for m in libs if m not in ("other", "this")
                      for _ in range(2)]
            reps, inner = (5, 2) if n > 4_000_000 else (10, 2)
            times: dict[str, list[float]] = {}
            for m in order:
                # K6 sorts in place: each call gets its own copy, made
                # before the timed window
                copies = iter([[w.clone() for w in words]
                               for _ in range(5 + reps * inner)])
                times.setdefault(m, []).append(time_ms(
                    lambda: launch(libs[m], next(copies), bits), reps=reps,
                    inner=inner))
                del copies
            plain = time_ms(lambda: sk.sort_words_ref(words, len(bits), bits),
                            reps=3, inner=1)
            lib_ms = time_ms(lambda: torch.sort(words[0]), reps=reps,
                             inner=inner)
            print(f"k6_ab shape={name} N={n} W={len(words)} bits={bits} "
                  + " ".join(f"{m}_ms={min(t)} ({', '.join(map(str, t))})"
                             for m, t in times.items())
                  + f" plain_ms={plain} torch_sort_ms={lib_ms}", flush=True)
            if args.profile:
                copy = [w.clone() for w in words]
                prof = device_kernel_ms(lambda: launch(libs["this"], copy,
                                                       bits))
                top = sorted(prof.items(), key=lambda kv: -kv[1][0])
                print(f"k6_profile shape={name} " + " ".join(
                    f"{_kernel(k)}={ms:.4f}/{c}" for k, (ms, c) in top),
                      flush=True)
            del words
            torch.cuda.empty_cache()
        if args.walls:
            walls(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
