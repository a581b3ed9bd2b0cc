"""A/B of kernel K5 (kmer_tpu_torch/csrc/histogram.cu) against another
tree's on one card.

    PYTHONPATH=. python scripts/ab_histogram.py OTHER_CSRC_DIR [VARIANT.cu ...]
        [--clusters N ...]

Builds this tree's histogram.cu, OTHER_CSRC_DIR/histogram.cu and each
VARIANT source with the port's nvcc flags (sm_90a) into a temporary
directory, checks every build against the plain version at every shape it
takes, bit for bit, then times them with CUDA events in turns (other,
this, this, other, then each variant twice) and prints one line a shape:
each build's smaller reading, ms.  The shapes, lanes seeded with numpy
and a tenth of them dead (weight 0, sentinel keys): indices into 2**16
bins at one k = 21 batch (MODE 0), HyperLogLog classes of one `card`
batch of one-word keys at k = 21 (MODE 1), of (hi, lo) pairs at k = 55
(MODE 2), and of keys of 3, 4 and 5 planes at k = 64, 101 and 130 (MODE
3, builds that have it; a `card` batch of 2048 reads of L = 160 each);
then the k = 101 batch with every lane dead, which takes MODE 3's fixed
cost alone (zeroing the bins, the flush's scan) beside the loads.
--clusters N ... times this tree's build at MODE 3's shapes also on N
clusters (N blocks at these bins) in place of the plan's one an SM.  A
build with `histogram_max_planes` takes an array of plane pointers; one
without takes (keys, keys_lo), as the kernel's entry did before.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from chip_smoke import time_ms
from kmer_tpu_torch.ops.encode import SENTINEL_KEY, word_bases
from kmer_tpu_torch.ops.kernels import histogram as hk
from kmer_tpu_torch.utils.build import NVCCFLAGS, nvcc

# (name, lanes, bits, k for HLL classes or 0, b, share of dead lanes)
SHAPES = [("index_b16", 1_146_880, 16, 0, 0, 0.1),
          ("card_k21_b10", 286_720, 15, 21, 10, 0.1),
          ("pair_k55_b10", 217_088, 15, 55, 10, 0.1),
          ("planes_k64_b10", 198_656, 15, 64, 10, 0.1),
          ("planes_k101_b10", 122_880, 15, 101, 10, 0.1),
          ("planes_k130_b10", 63_488, 15, 130, 10, 0.1),
          ("planes_k101_dead", 122_880, 15, 101, 10, 1.0)]


def build(src: str, out_dir: str, name: str) -> ctypes.CDLL:
    """nvcc `src` with the port's flags (sm_90a) into lib{name}.so in
    out_dir; returns the loaded library, its entries not yet declared."""
    so = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc(), *NVCCFLAGS, "-shared", "-o", so, src],
                   check=True)
    return ctypes.CDLL(so)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare a K5 library's launch entry, in either of its forms."""
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.histogram_launch.restype = i
    try:
        lib.histogram_max_planes
        lib.planes_entry = True
        lib.histogram_launch.argtypes = [vp, i, vp, i64, i, i, i, i, vp, i,
                                         i, i64, vp]
    except AttributeError:
        lib.planes_entry = False
        lib.histogram_launch.argtypes = [vp, vp, vp, i64, i, i, i, i, vp, i,
                                         i, i64, vp]
    return lib


def launch(lib, planes, weight, bits: int, k: int, b: int, out,
           clusters: int = 0) -> None:
    """One launch on the wrapper's plan, or on `clusters` clusters."""
    n = weight.numel()
    grid = hk.plan(n, bits, torch.cuda.get_device_properties(
        weight.device).multi_processor_count)
    if clusters:
        chunk = -(-n // clusters // hk.LANES) * hk.LANES
        grid = grid._replace(clusters=-(-n // chunk), chunk=chunk)
    if lib.planes_entry:
        ptrs = (ctypes.c_void_p * len(planes))(*[p.data_ptr()
                                                 for p in planes])
        head = (ptrs, len(planes))
    else:
        head = (planes[0].data_ptr(),
                planes[1].data_ptr() if len(planes) == 2 else None)
    rc = lib.histogram_launch(*head, weight.data_ptr(), weight.numel(),
                              bits, int(k > 0), k, b, out.data_ptr(),
                              grid.cluster, grid.clusters, grid.chunk,
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def inputs(rng, n: int, bits: int, k: int, share: float, dev):
    """(planes, int8 weights) of n lanes, `share` of them dead."""
    weight = rng.integers(1, 3, n).astype(np.int8)
    dead = rng.random(n) < share
    weight[dead] = 0
    if not k:
        planes = [rng.integers(0, 1 << bits, n)]
    else:
        planes = [rng.integers(0, 1 << (2 * nb), n) if nb < 32 else
                  rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
                  for nb in word_bases(k)]
        for p in planes:
            p[dead] = SENTINEL_KEY
    return ([torch.from_numpy(p).to(dev) for p in planes],
            torch.from_numpy(weight).to(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other tree's kmer_tpu_torch/csrc")
    ap.add_argument("variants", nargs="*", help="more histogram.cu sources")
    ap.add_argument("--clusters", type=int, nargs="*", default=[],
                    help="also time this tree's build at MODE 3's shapes "
                         "on each number of clusters, not the plan's")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    here = os.path.join(os.path.dirname(os.path.abspath(hk.__file__)),
                        "..", "..", "csrc", "histogram.cu")
    srcs = {"other": os.path.join(args.other, "histogram.cu"), "this": here}
    srcs.update({os.path.basename(v): v for v in args.variants})
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: bind(build(src, tmp, f"k5_{i}"))
                for i, (name, src) in enumerate(srcs.items())}
        for name, n, bits, k, b, share in SHAPES:
            planes, weight = inputs(rng, n, bits, k, share, dev)
            if k:
                want = hk.hll_class_histogram_ref(
                    tuple(planes) if len(planes) > 1 else planes[0], weight,
                    k=k, b=b)
            else:
                want = hk.index_histogram_ref(planes[0], weight, bits)
            fns = {}
            for lib_name, lib in libs.items():
                if len(planes) > 2 and not lib.planes_entry:
                    continue
                out = torch.zeros(1 << bits, dtype=torch.int64, device=dev)
                launch(lib, planes, weight, bits, k, b, out)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{lib_name} != plain version at "
                                         f"{name}")
                fns[lib_name] = (lambda lib=lib, out=out: launch(
                    lib, planes, weight, bits, k, b, out))
            for c in args.clusters if k > 63 else ():
                out = torch.zeros(1 << bits, dtype=torch.int64, device=dev)
                launch(libs["this"], planes, weight, bits, k, b, out, c)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{c} clusters != plain version at "
                                         f"{name}")
                fns[f"this_c{c}"] = (lambda c=c, out=out: launch(
                    libs["this"], planes, weight, bits, k, b, out, c))
            order = [m for m in ("other", "this", "this", "other")
                     if m in fns]
            order += [m for m in fns if m not in ("other", "this")
                      for _ in range(2)]
            times: dict[str, list[float]] = {}
            for m in order:
                times.setdefault(m, []).append(time_ms(fns[m]))
            print(f"k5_ab shape={name} lanes={n} bits={bits} k={k} "
                  + " ".join(f"{m}_ms={min(t)} ({', '.join(map(str, t))})"
                             for m, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
