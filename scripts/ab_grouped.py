"""A/B of the grouped sorts K2b and K2c (grouped_sort_count_launch in
kmer_tpu_torch/csrc/grouped_count.cu) against another tree's, on one CUDA
card.  Run from the repo root:

    mkdir -p _chip/parent
    git archive <commit> kmer_tpu_torch/csrc | tar -x -C _chip/parent
    PYTHONPATH=. python scripts/ab_grouped.py _chip/parent/kmer_tpu_torch/csrc [--variants] [--walls]

It builds, all at once with nvcc -Xptxas -v: this tree's grouped_count.cu
(into kmer_tpu_torch/_build, where the wrapper loads it); the other
tree's, with an entry added that reports its sort launch (threads, blocks,
shared bytes, registers, spills, resident blocks an SM); the other tree's
sort with its network, its run search or both taken out (timed only:
their outputs are wrong); two floors from a grid of the card's resident
blocks, 16-byte accesses covering 512 contiguous bytes a warp
instruction: a copy (each key read, each key and an int32 count written:
20 bytes a row at W = 1) and the writes alone; and with --variants this
tree's rejected variants (text substitutions of grouped_count.cu).  It
prints each kernel's registers and spills, compares the SASS of K2a
(run_lengths_kernel) across the two trees, prints the launch each body of
this tree makes, checks this tree's kernel and every variant against the
plain versions (grouped_count_ref, grouped_count_strided_ref) at the
timed shapes and at edge cases, then times with CUDA events, in turns
(other, this, variants..., variants..., this, other): K2b and K2c at the
k = 21 unfused step's keys (4480, 256) and (16, 71680), at the k = 55
step's pairs (3392, 256) and (16, 54272), and at other group sizes up to
max_group_rows(W) in both layouts, each beside torch.sort of one word at
the same shape (a yardstick: no run lengths) and its byte bound.  With
--walls it then runs the k = 21 corpus of chip_smoke.py's phase 4 (1 M
reads) end to end under KMER_TPU_STEP=legacy KMER_TPU_GROUPED=pallas (K2b)
and KMER_TPU_STEP=t (K2c), with either tree's library in the wrapper, in
turns (other, this, this, other), every table equal to the first.
Builds of the other tree, the floors and the variants go to
kmer_tpu_torch/_build/ab_grouped/.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import chip_smoke as cs
from kmer_tpu_torch.ops.encode import SENTINEL_KEY
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import grouped_count as gk
from kmer_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR, NVCCFLAGS, nvcc

AB_DIR = os.path.join(BUILD_DIR, "ab_grouped")
INFO_KEYS = ("threads", "blocks", "smem", "registers", "spill_bytes",
             "blocks_per_sm")

# the other tree's sort launch, reported: (G + gpb - 1) / gpb blocks of
# SORT_THREADS with gpb * m * W int64 of dynamic shared memory
OTHER_INFO = r'''
template <int W>
static void other_report(int* info, int64_t G, int m) {
  auto kern = grouped_sort_kernel<W>;
  const int gpb = m < MIN_ROWS ? MIN_ROWS / m : 1;
  const size_t smem = (size_t)gpb * m * W * sizeof(int64_t);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaFuncAttributes a = {};
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        SORT_THREADS, smem);
  const int v[7] = {SORT_THREADS, (int)((G + gpb - 1) / gpb), (int)smem,
                    a.numRegs, (int)a.localSizeBytes, per_sm, (int)err};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
}
extern "C" int other_info(int W, int64_t G, int m, int* info) {
  switch (W) {
    case 1: other_report<1>(info, G, m); break;
    case 2: other_report<2>(info, G, m); break;
    case 3: other_report<3>(info, G, m); break;
    default: other_report<4>(info, G, m); break;
  }
  return info[6];
}
'''

# n rows from a grid of `blocks` blocks of 256 threads, each warp a span of
# 512 rows in turn, 16-byte accesses covering 512 contiguous bytes a warp
# instruction: copy != 0 reads the keys and writes them back with an int32
# count each (20 bytes a row), copy == 0 writes constant keys and counts
# (12 bytes a row)
FLOORS = r'''
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
floor_kernel(const int64_t* in, int64_t* out, int32_t* counts, int64_t n,
             int copy) {
  const int lane = threadIdx.x & 31;
  const int64_t spans = n / 512;
  for (int64_t sp = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5); sp < spans;
       sp += (int64_t)gridDim.x * 8) {
    const int64_t g0 = sp * 512;
    longlong2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int64_t g = g0 + 64 * k + 2 * lane;
      v[k] = copy ? __ldg(reinterpret_cast<const longlong2*>(in + g))
                  : make_longlong2(g, g + 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      reinterpret_cast<longlong2*>(out + g0 + 64 * k + 2 * lane)[0] = v[k];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      reinterpret_cast<int4*>(counts + g0 + 128 * k + 4 * lane)[0] =
          make_int4(1, 0, (int)v[k].x, 0);
  }
}
extern "C" int floor_launch(const int64_t* in, int64_t* out, int32_t* counts,
                            int64_t n, int blocks, int copy, void* stream) {
  floor_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, counts, n, copy);
  return (int)cudaGetLastError();
}
extern "C" int floor_per_sm(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, floor_kernel, 256, 0);
}
'''


def other_variants(src):
    """The other tree's sort with parts taken out (timed only): name ->
    source."""
    no_net = ("for (int kk = 2; kk <= m; kk <<= 1) {",
              "for (int kk = 2 * m; kk <= m; kk <<= 1) {")
    no_search = ("while (lo < hi) {", "while (false) {")
    return {"other_no_net": _substitute(src, [no_net]),
            "other_no_search": _substitute(src, [no_search]),
            "other_no_net_no_search": _substitute(src, [no_net, no_search])}


def this_variants(src):
    """This tree's variants, each a text substitution of grouped_count.cu:
    name -> source."""
    stcs = [("    reinterpret_cast<longlong2*>(p + row)[0] = v;",
             "    __stcs(reinterpret_cast<longlong2*>(p + row), v);"),
            ("      for (int q = 0; q < W; ++q) out.w[q][e] = c.x[i][q];\n"
             "      counts[e] = cnt[i];",
             "      for (int q = 0; q < W; ++q) __stcs(out.w[q] + e, "
             "c.x[i][q]);\n      __stcs(counts + e, cnt[i]);")]
    subs = {
        # 2, 4 or 16 words a lane where a group allows (a group over more
        # or fewer lanes; 2 at W = 1 is a group over m / 32 lanes)
        "v_warp_lane_words2": [("constexpr int WARP_LANE_WORDS = 8;",
                                "constexpr int WARP_LANE_WORDS = 2;")],
        "v_warp_lane_words4": [("constexpr int WARP_LANE_WORDS = 8;",
                                "constexpr int WARP_LANE_WORDS = 4;")],
        "v_warp_lane_words16": [("constexpr int WARP_LANE_WORDS = 8;",
                                 "constexpr int WARP_LANE_WORDS = 16;")],
        # the block body's planes 32 rows apart in shared memory
        "v_block_rows32": [
            ("  const int rows = gpb * pitch;",
             "  const int rows = (gpb * pitch + 31) & ~31;"),
            ("  const size_t smem = (size_t)gpb * (a.m + 1) * W * "
             "sizeof(int64_t);",
             "  const size_t smem = ((size_t)gpb * (a.m + 1) + 31) / 32 * 32 "
             "* W * sizeof(int64_t);")],
        # registers capped for 9 blocks an SM where a lane holds 8 words
        "v_warp_lb9": [("__launch_bounds__(WARP_THREADS)\nwarp_sort_kernel",
                        "__launch_bounds__(WARP_THREADS, R * W <= 8 ? 9 : 1)"
                        "\nwarp_sort_kernel")],
        # registers capped for the blocks an SM a lane's 2 R W words allow
        "v_warp_lbw": [("__launch_bounds__(WARP_THREADS)\nwarp_sort_kernel",
                        "__launch_bounds__(WARP_THREADS, 65536 / "
                        "(WARP_THREADS * (2 * R * W + 40)))\n"
                        "warp_sort_kernel")],
        "v_stcs": stcs,
        "v_col_threads64": [("constexpr int COL_THREADS = 128;",
                             "constexpr int COL_THREADS = 64;")],
        # timed only (wrong outputs): the warp body without its network,
        # without its shuffle stages, without its register stages
        "t_warp_no_net": [("    sort_span<R, W>(x, m);\n", "")],
        "t_warp_no_shfl": [("    for (int j = kk >> 1; j >= R; j >>= 1) {",
                            "    for (int j = kk >> 1; j >= R && m < 0; "
                            "j >>= 1) {")],
        "t_warp_no_reg": [(
            "        if ((k & j) == 0) exchange<W>(x[k], x[k + j], up);",
            "        if ((k & j) == 0 && m < 0) exchange<W>(x[k], x[k + j], "
            "up);")],
        "v_warp_threads256": [("constexpr int WARP_THREADS = 128;",
                               "constexpr int WARP_THREADS = 256;")],
        # m = 1024 through the block body
        "v_warp_max512": [("constexpr int WARP_ROWS = 32;",
                           "constexpr int WARP_ROWS = 16;")],
        # m = 32 at W = 2 and m = 16 at W = 4 through the block body
        "v_col_words32": [("constexpr int COL_WORDS = 64;",
                           "constexpr int COL_WORDS = 32;")],
        # the block body's pitch unpadded
        "v_block_nopad": [("  const int pitch = m + 1;",
                           "  const int pitch = m;")],
    }
    return {name: _substitute(src, pairs) for name, pairs in subs.items()}


def _substitute(src, pairs):
    for a, b in pairs:
        if a not in src:
            raise ValueError(f"variant text not found: {a[:60]!r}")
        src = src.replace(a, b)
    return src


def say(*a):
    print(*a, flush=True)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True)


def build_all(other, variants):
    os.makedirs(AB_DIR, exist_ok=True)
    os.makedirs(BUILD_DIR, exist_ok=True)
    for f in os.listdir(CSRC_DIR):            # this tree's headers
        if f.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, f)) as fh:
                header = fh.read()
            with open(os.path.join(AB_DIR, f), "w") as fh:
                fh.write(header)

    def put(name, text):
        path = os.path.join(AB_DIR, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        return path

    # the other tree's source beside its own headers
    with open(os.path.join(other, "grouped_count.cu")) as fh:
        other_src = fh.read()
    texts = {"other": other_src + OTHER_INFO, "floors": FLOORS}
    texts.update(other_variants(other_src))
    this_src = open(os.path.join(CSRC_DIR, "grouped_count.cu")).read()
    if variants:
        texts.update(this_variants(this_src))
    builds = {"this": (os.path.join(CSRC_DIR, "grouped_count.cu"),
                       os.path.join(BUILD_DIR, "libkmer_grouped_count.so"))}
    for name, text in texts.items():
        src = (os.path.join(other, f"_ab_{name}.cu")
               if name.startswith("other") else put(name, text))
        if name.startswith("other"):
            with open(src, "w") as fh:
                fh.write(text)
        builds[name] = (src, os.path.join(AB_DIR, f"lib{name}.so"))
    t0 = time.time()
    procs = {k: subprocess.Popen([nvcc(), *NVCCFLAGS, "-Xptxas", "-v",
                                  "-shared", "-o", out, src],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, out) in builds.items()}
    # the kernel that makes the inputs, at the same time
    feeder = threading.Thread(target=ek.load)
    feeder.start()
    logs, bad = {}, False
    for k, p in procs.items():
        logs[k] = p.communicate()[0]
        if p.returncode:
            say(f"build {k} failed:\n{logs[k][-4000:]}")
            bad = True
    feeder.join()
    say(f"builds done after {time.time() - t0:.1f} s ({len(builds)} "
        "libraries)")
    if bad:
        sys.exit(1)
    for k, log in logs.items():
        fn, spill = None, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = sh(["c++filt", m.group(1)]).stdout.strip()
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          line)
            if m:
                spill = m.group(2)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and "_kernel" in fn:
                name = re.sub(r"^void |\(anonymous namespace\)::", "", fn)
                say(f"ptxas {k} {name.split('(')[0][-60:]}: {m.group(1)} "
                    f"registers, {spill} bytes spilled")
    return {k: out for k, (_, out) in builds.items()}


def sass(so):
    """Function name -> SASS lines, with addresses, whitespace and the
    file-wide label numbers normalised."""
    funcs, name, body = {}, None, []
    for line in sh(["cuobjdump", "-sass", so]).stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = body
            name, body = sh(["c++filt", m.group(1)]).stdout.strip(), []
        elif name:
            body.append(" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "",
                                        line).split()))
    if name:
        funcs[name] = body
    for f, body in funcs.items():
        labels = {}
        funcs[f] = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(0), f".L{len(labels)}"), ln) for ln in body]
    return funcs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other tree's kmer_tpu_torch/csrc")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--walls", action="store_true",
                    help="also run the K2b and K2c steps end to end with "
                    "each tree's library")
    ap.add_argument("--shapes", default="",
                    help="time only the shapes whose name matches this "
                    "regular expression (all are checked)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        say("needs a CUDA device")
        return 2
    say(sh(["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"]).stdout.strip())
    libs = build_all(args.other, args.variants)
    a, b = sass(libs["other"]), sass(libs["this"])
    for f in sorted(a):
        if "run_lengths_kernel" in f:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", f)
            say(f"sass {name.split('(')[0][-40:]} "
                f"same_as_other={a[f] == b.get(f)} lines={len(a[f])}")
    for f in sorted(b):
        if "warp_sort_kernel" in f or "column_sort_kernel<16" in f:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", f)
            ops = []
            for ln in b[f]:
                tok = ln.split()
                tok = tok[1:] if tok and tok[0].startswith("@") else tok
                if tok and re.match(r"^[A-Z][A-Z0-9_.]*$", tok[0]):
                    ops.append(tok[0])
            say(f"sass this {name.split('(')[0][-40:]} instructions="
                f"{len(ops)} shfl={sum(o.startswith('SHFL') for o in ops)} "
                f"sel={sum(o.startswith('SEL') for o in ops)} "
                f"isetp={sum(o.startswith('ISETP') for o in ops)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def stream():
        return torch.cuda.current_stream().cuda_stream

    sorts = {"other": ctypes.CDLL(libs["other"]), "this": gk.load()}
    for name, so in libs.items():
        if name.startswith(("other_no_", "v_", "t_")):
            sorts[name] = ctypes.CDLL(so)
    for lib in sorts.values():
        lib.grouped_sort_count_launch.argtypes = ([vp] * 8 + [i32, i64, i32,
                                                              i64, i64, vp,
                                                              vp])
        lib.run_lengths_grouped_launch.argtypes = [vp] * 4 + [i32, i64, i32,
                                                              vp, vp]
    sorts["other"].other_info.argtypes = [i32, i64, i32, vp]
    floors = ctypes.CDLL(libs["floors"])
    floors.floor_launch.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    floors.floor_per_sm.argtypes = [vp]

    # ------------------------------------------------------------ inputs
    rng = np.random.default_rng(4)
    gen = torch.Generator(device=dev).manual_seed(4)

    def batch(k):
        return [t.to(dev) for t in cs.kernel_batch(
            rng, cs.MAIN_B, cs.MAIN_L, k, packed=True, amb=False,
            short=False)]

    def padded(planes, m):
        flat = [w.reshape(-1) for w in planes]
        pad = -flat[0].numel() % m
        return [torch.cat([w, torch.full((pad,), SENTINEL_KEY, device=dev)])
                for w in flat]

    def rows(n, W, hi=8, dead=0.2):
        planes = [torch.randint(0, hi, (n,), generator=gen, device=dev)
                  for _ in range(W)]
        gone = torch.rand((n,), generator=gen, device=dev) < dead
        return [torch.where(gone, SENTINEL_KEY, p) for p in planes]

    k21 = padded([ek.extract_keys(*batch(cs.K), cs.K, canonical=True,
                                  packed_width=cs.MAIN_L)], 256)
    k55 = padded(ek.extract_keys(*batch(cs.WIDE_K), cs.WIDE_K,
                                 canonical=True, packed_width=cs.MAIN_L),
                 256)
    # name -> (flat planes, m, strided): the route shapes, then other m
    timed = {
        "K2b_route_w1": (k21, 256, False), "K2c_route_w1": (k21, 16, True),
        "K2b_k55_w2": (k55, 256, False), "K2c_k55_w2": (k55, 16, True)}
    n1 = k21[0].numel()
    for m in (2, 16, 32, 64, 128, 512, 1024, 4096, gk.max_group_rows(1)):
        for strided in (False, True):
            timed[f"{'K2c' if strided else 'K2b'}_m{m}_w1"] = (
                rows(n1, 1, hi=1 << 20), m, strided)
    for m, W in ((16, 4), (32, 2), (64, 3), (256, 4), (512, 2), (4096, 4),
                 (gk.max_group_rows(2), 2)):
        for strided in (False, True):
            timed[f"{'K2c' if strided else 'K2b'}_m{m}_w{W}"] = (
                rows(n1 // W // m * m, W, hi=64), m, strided)
    edges = {}
    for m in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048):
        for W in (1, 2, 3, 4):
            if m > gk.max_group_rows(W):
                continue
            for strided in (False, True):
                G = 2 * 64 + 1 if m < 1024 else 3
                edges[f"m{m}_w{W}_{'c' if strided else 'b'}"] = (
                    rows(G * m, W, hi=3), m, strided)
    for W in (1, 4):
        big = gk.max_group_rows(W)
        for strided in (False, True):
            edges[f"max_w{W}_{'c' if strided else 'b'}"] = (
                rows(2 * big, W, hi=50), big, strided)
    for strided in (False, True):
        one = [torch.full((4096,), 7, device=dev)]
        edges[f"one_run_{'c' if strided else 'b'}"] = (one, 256, strided)
        dead = [torch.full((8192,), SENTINEL_KEY, device=dev)] * 2
        edges[f"sentinels_{'c' if strided else 'b'}"] = (dead, 16, strided)
        base = rows(1 + 64 * 129 * 2, 2, hi=3)
        edges[f"unaligned_{'c' if strided else 'b'}"] = (
            [p[1:] for p in base], 64, strided)
        last = rows(96 * 32, 3, hi=2)
        last[0] = torch.zeros_like(last[0])
        last[1] = torch.zeros_like(last[1])
        edges[f"tie_but_last_{'c' if strided else 'b'}"] = (last, 32,
                                                            strided)

    def shaped(planes, m, strided):
        n = planes[0].numel()
        return [p.view(m, n // m) if strided else p.view(n // m, m)
                for p in planes]

    def sort_launcher(lib, planes, m, strided):
        n = planes[0].numel()
        G = n // m
        es, gs = (G, 1) if strided else (1, m)
        outs = [torch.empty(n, dtype=torch.int64, device=dev)
                for _ in planes]
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
        ptr = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
        optr = [p.data_ptr() for p in outs] + [None] * (4 - len(planes))

        def fn():
            rc = lib.grouped_sort_count_launch(
                *ptr, *optr, len(planes), G, m, es, gs, cnt.data_ptr(),
                stream())
            assert rc == 0, rc
            return outs, cnt
        return fn

    def err_of(got, planes, m, strided):
        ref = gk.grouped_count_strided_ref if strided else gk.grouped_count_ref
        want_s, want_c = ref(shaped(planes, m, strided))
        outs, cnt = got
        err = int((cnt.view(want_c.shape).long() - want_c.long()).abs().max())
        for o, w in zip(outs, want_s):
            err = max(err, int((o.view(w.shape) - w).abs().max()))
        return err

    fails = 0
    for name, lib in sorts.items():
        if name.startswith(("other", "t_")):
            continue
        worst, where = 0, ""
        for case, (planes, m, strided) in {**edges, **timed}.items():
            got = sort_launcher(lib, planes, m, strided)()
            torch.cuda.synchronize()
            err = err_of(got, planes, m, strided)
            if err > worst:
                worst, where = err, case
        fails += worst != 0
        say(f"check K2b/K2c {name} cases={len(edges) + len(timed)} "
            f"max_abs_err={worst} {where}")
    say(f"checks failed={fails}")
    if fails:
        return 1

    # ------------------------------------------------------------ geometry
    for case, (planes, m, strided) in timed.items():
        G, W = planes[0].numel() // m, len(planes)
        got = (ctypes.c_int * 7)()
        sorts["other"].other_info(W, G, m, got)
        line = "other " + " ".join(f"{k}={v}" for k, v in
                                   zip(INFO_KEYS, got))
        if hasattr(gk, "launch_info"):
            info = gk.launch_info(G, m, W, strided=strided)
            line += " | this " + " ".join(f"{k}={v}"
                                          for k, v in info.items())
        say(f"launch case={case} G={G} m={m} W={W} {line}")
    per_sm = ctypes.c_int()
    floors.floor_per_sm(ctypes.byref(per_sm))
    say(f"floor blocks_per_sm={per_sm.value} sms={sms}")

    # ------------------------------------------------------------ timing
    def turns(label, fns):
        names = list(fns)
        got = {nm: [] for nm in names}
        for nm in names + names[::-1]:
            got[nm].append(cs.time_ms(fns[nm]))
        say(f"ab {label} " + " ".join(
            f"{nm}={got[nm][0]:.5f},{got[nm][1]:.5f}" for nm in names))

    order = ["other"] + [k for k in sorts if k.startswith("other_no_")] + [
        "this"] + [k for k in sorts if k.startswith(("v_", "t_"))]
    route = ("route_w1", "k55_w2")
    hbm = cs.hbm_bytes_per_s(dev)
    for case, (planes, m, strided) in timed.items():
        if not re.search(args.shapes, case):
            continue
        n, W = planes[0].numel(), len(planes)
        fns = {nm: sort_launcher(sorts[nm], planes, m, strided)
               for nm in order
               if nm in ("other", "this") or nm.startswith("v_")
               or case.endswith(route)}
        bound_ms = n * (16 * W + 4) / hbm * 1e3
        turns(f"{case} n={n} W={W} m={m} bound_ms={bound_ms:.5f}", fns)
        two = shaped(planes, m, strided)[0]
        yard = cs.time_ms(lambda: torch.sort(two, dim=0 if strided else 1))
        say(f"yardstick {case} torch_sort_one_word_ms={yard:.5f}")
    for planes in (k21, k55):
        n = planes[0].numel()
        out = torch.empty(n, dtype=torch.int64, device=dev)
        cnt = torch.empty(n, dtype=torch.int32, device=dev)
        got = {}
        for copy in (1, 0):
            got[copy] = cs.time_ms(lambda: floors.floor_launch(
                planes[0].data_ptr(), out.data_ptr(), cnt.data_ptr(), n,
                sms * per_sm.value, copy, stream()))
        say(f"floors n={n} copy_20B_a_row_ms={got[1]:.5f} "
            f"({n * 20 / got[1] / 1e9:.3f} TB/s) "
            f"stores_12B_a_row_ms={got[0]:.5f} "
            f"({n * 12 / got[0] / 1e9:.3f} TB/s) "
            f"bound_20B_ms={n * 20 / hbm * 1e3:.5f}")
    if args.walls:
        walls(dev, sorts["other"], sorts["this"])
    say("done")
    return 0


def walls(dev, other, this):
    """The k = 21 corpus end to end under KMER_TPU_STEP=legacy
    KMER_TPU_GROUPED=pallas (K2b) and KMER_TPU_STEP=t (K2c), with either
    tree's library in the wrapper (everything else this tree's), in turns
    other, this, this, other; every table of a setting must equal its
    first, and every run must launch its kernel once a batch."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.generator import genome_reads_fasta
    from kmer_tpu_torch.utils import stagetime
    cfg = KmerConfig(k=cs.K, canonical=True)
    batches = -(-cs.N_READS // cfg.batch_reads)
    runs = {"grouped=pallas": (dict(KMER_TPU_STEP="legacy",
                                    KMER_TPU_GROUPED="pallas"),
                               "grouped_launches"),
            "step=t": (dict(KMER_TPU_STEP="t"), "strided_launches")}
    saved = {k: os.environ.get(k) for k in ("KMER_TPU_STEP",
                                            "KMER_TPU_GROUPED")}

    def setenv(env):
        for k in saved:
            os.environ.pop(k, None)
        os.environ.update(env)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.fasta")
        with open(path, "w") as f:
            f.write(genome_reads_fasta(cs.N_READS, cs.READ_LEN,
                                       genome_len=cs.GENOME_LEN, seed=0,
                                       error_rate=cs.ERROR_RATE))
        try:
            for env, _ in runs.values():                   # warm-up
                setenv(env)
                count_fasta(path, cfg, device=dev)
            want = {}
            for turn, (name, lib) in enumerate(
                    [("other", other), ("this", this), ("this", this),
                     ("other", other)]):
                gk._lib = lib
                for label, (env, counter) in runs.items():
                    setenv(env)
                    before = getattr(gk, counter)
                    times: dict[str, float] = {}
                    torch.cuda.synchronize()
                    with stagetime.collect(times):
                        table = count_fasta(path, cfg, device=dev)
                    launches = getattr(gk, counter) - before
                    want.setdefault(label, table)
                    if table != want[label] or launches != batches:
                        raise AssertionError(f"{name} {label}: table differs "
                                             f"or {launches} launches")
                    say(f"wall turn={turn} lib={name} run={label} "
                        f"launches={launches} wall_s={times['total']:.4f} "
                        "stages_s=" + json.dumps(
                            {k: round(v, 4) for k, v in times.items()},
                            sort_keys=True))
        finally:
            setenv({k: v for k, v in saved.items() if v is not None})
            gk._lib = this


if __name__ == "__main__":
    raise SystemExit(main())
