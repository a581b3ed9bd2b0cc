"""A/B of the fused gapped count K3 (kmer_tpu_torch/csrc/fused_gapped.cu)
against another tree's, on one CUDA card.  Run from the repo root:

    mkdir -p _chip/parent
    git archive <commit> kmer_tpu_torch/csrc | tar -x -C _chip/parent
    PYTHONPATH=. python scripts/ab_gapped.py _chip/parent/kmer_tpu_torch/csrc [--variants]

It builds, all at once with nvcc -Xptxas -v: this tree's fused_gapped.cu
(into kmer_tpu_torch/_build, where the wrapper loads it); the other
tree's, with an entry added that reports its launch (threads, blocks,
shared bytes, registers, spills, resident blocks an SM); the other tree's
kernel with its chunk-size search taken out and with its table build taken
out (timed only: their lanes are wrong); the other tree's grid storing
constant lanes with the same stores and no row, table or search; three
store floors, each writing the batch's (hi, lo, count) lanes as constants
from a grid of resident blocks on every SM: 16-byte stores that cover a
warp's 512 contiguous bytes, 16-byte stores of a thread's run of 16
lanes (a 128-byte stride), and this tree's layout (a thread's seg lanes
a step, a warp's 32 x seg lanes contiguous); and with --variants this
tree's rejected variants (text substitutions of fused_gapped.cu).  It
prints each kernel's registers and spills, checks this tree's kernel and
every variant against the plain version (fused_gapped_count_ref) at the
timed shapes and at edge cases, then times with CUDA events, in turns
(other, this, variants..., variants..., this, other): the parity shape
(B = 256, L = 416, packed rows, l = r = 27, c in [80, 140], seg 2), u8
rows with the ambiguity mask at (512, 416), seg 4, 8 and 16, asymmetric
windows and one 12,288-base row; the other tree's decomposition and the
floors at the parity shape and at (512, 416).  With --walls it then runs
the gapped path end to end with either tree's K3 in the wrapper, in turns
(other, this, this, other): chip_smoke's 4000 reference-style records by
sort, compact and device merge, and the parity dump of sample.fasta.
Builds of the other tree, the floors and the variants go to
kmer_tpu_torch/_build/ab_gapped/.
"""
import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from kmer_tpu_torch.ops.kernels import fused_gapped as fg
from kmer_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR, NVCCFLAGS, nvcc

AB_DIR = os.path.join(BUILD_DIR, "ab_gapped")
INFO_KEYS = ("threads", "blocks", "smem", "registers", "spill_bytes",
             "blocks_per_sm")

# the other tree's launch, reported: its grid is (B, tiles) of THREADS,
# with smem_bytes of dynamic shared memory
OTHER_INFO = r'''
template <int SEG, bool PACKED>
static void other_report(int* info, int B, int64_t tiles, size_t smem) {
  auto kern = fused_gapped_kernel<SEG, PACKED>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaFuncAttributes a = {};
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, smem);
  const int v[7] = {THREADS, (int)(B * tiles), (int)smem, a.numRegs,
                    (int)a.localSizeBytes, per_sm, (int)err};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
}
extern "C" int other_info(int packed, int seg, int B, int L, int l_len,
                          int r_len, int64_t T_pad, int* info) {
  const size_t smem = (size_t)smem_bytes(L, l_len, r_len);
  const int64_t tiles = (T_pad + TILE - 1) / TILE;
#define OTHER_SEG(S)                                                  \
  case S:                                                             \
    if (packed) other_report<S, true>(info, B, tiles, smem);          \
    else other_report<S, false>(info, B, tiles, smem);                \
    break;
  switch (seg) {
    OTHER_SEG(2) OTHER_SEG(4) OTHER_SEG(8) OTHER_SEG(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OTHER_SEG
  return info[6];
}
'''

# the other tree's grid (B, ceil(T_pad / 4096)) of 256 threads and its
# stores (an 8-byte store a lane a plane, then a byte a count), the lanes
# constant: no row, no table, no search; launched with the other tree's
# dynamic shared bytes, so that as many blocks fit an SM
CONST_GRID = r'''
#include <cstdint>
#include <cuda_runtime.h>
template <int SEG>
__global__ void __launch_bounds__(256)
const_lanes(int64_t* hi, int64_t* lo, int8_t* counts, int64_t T_pad) {
  const int b = blockIdx.x;
  int64_t* hrow = hi + (size_t)b * T_pad;
  int64_t* lrow = lo + (size_t)b * T_pad;
  int8_t* crow = counts + (size_t)b * T_pad;
  const int64_t tile0 = (int64_t)blockIdx.y * 4096;
  for (int s = threadIdx.x; s < 4096 / SEG; s += 256) {
    const int64_t t0 = tile0 + (int64_t)s * SEG;
    if (t0 >= T_pad) break;
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      hrow[t0 + j] = t0 + j;
      lrow[t0 + j] = b;
    }
#pragma unroll
    for (int j = 0; j < SEG; ++j) crow[t0 + j] = (int8_t)(j + 1);
  }
}
extern "C" int const_grid(int64_t* hi, int64_t* lo, int8_t* counts, int B,
                          int64_t T_pad, int smem, void* stream) {
  auto kern = const_lanes<2>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  const dim3 grid(B, (unsigned)((T_pad + 4095) / 4096));
  kern<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(hi, lo,
                                                                counts, T_pad);
  return (int)cudaGetLastError();
}
'''

# the lanes of a (B, T_pad) batch as constants from `blocks` blocks of 256
# threads, grid-stride over warp spans of 512 lanes: layout 0, 16-byte
# stores covering 512 contiguous bytes a warp instruction (counts: one
# 16-byte store a thread); layout 1, a thread's run of 16 consecutive lanes
# stored 16 bytes at a time (a 128-byte stride across the warp; counts:
# one 16-byte store); layout 2, a thread's 2 lanes a step (a warp's 64
# lanes contiguous: one 16-byte store a plane, a 2-byte count)
STORE_FLOOR = r'''
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
floor_kernel(int64_t* hi, int64_t* lo, int8_t* counts, int64_t n,
             int layout) {
  const int lane = threadIdx.x & 31;
  const int64_t spans = (n + 511) / 512;
  for (int64_t sp = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5); sp < spans;
       sp += (int64_t)gridDim.x * 8) {
    const int64_t g0 = sp * 512;
    if (layout == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t g = g0 + 64 * k + 2 * lane;
        if (g < n) {
          reinterpret_cast<longlong2*>(hi + g)[0] = make_longlong2(g, g + 1);
          reinterpret_cast<longlong2*>(lo + g)[0] = make_longlong2(sp, k);
        }
      }
      const int64_t g = g0 + 16 * lane;
      if (g + 16 <= n)
        reinterpret_cast<int4*>(counts + g)[0] = make_int4(1, 2, 3, 4);
    } else if (layout == 1) {
      const int64_t g = g0 + 16 * lane;
      if (g + 16 <= n) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          reinterpret_cast<longlong2*>(hi + g)[k] =
              make_longlong2(g + k, g + k + 1);
          reinterpret_cast<longlong2*>(lo + g)[k] = make_longlong2(sp, k);
        }
        reinterpret_cast<int4*>(counts + g)[0] = make_int4(1, 2, 3, 4);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t g = g0 + 64 * k + 2 * lane;
        if (g < n) {
          reinterpret_cast<longlong2*>(hi + g)[0] = make_longlong2(g, g + 1);
          reinterpret_cast<longlong2*>(lo + g)[0] = make_longlong2(sp, k);
          reinterpret_cast<int16_t*>(counts + g)[0] = (int16_t)0x0101;
        }
      }
    }
  }
}
extern "C" int store_floor(int64_t* hi, int64_t* lo, int8_t* counts,
                           int64_t n, int blocks, int layout, void* stream) {
  floor_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      hi, lo, counts, n, layout);
  return (int)cudaGetLastError();
}
extern "C" int floor_per_sm(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, floor_kernel, 256, 0);
}
'''


def other_variants(src):
    """The other tree's kernel with parts taken out (timed only: wrong
    lanes): name -> source."""
    search = src[src.index("    int lo_c = c_min, hi_c = c_hi;"):
                 src.index("    int c = lo_c;")]
    return {
        "other_no_search": _substitute(src, [(search,
                                              "    int lo_c = c_min;\n")]),
        "other_no_table": _substitute(src, [
            ("  build_table(ltab, cs, P_l, l_len, mask_amb);\n"
             "  if (r_len != l_len) build_table(rtab, cs, P_r, r_len, "
             "mask_amb);\n", "")]),
    }


def this_variants(src):
    """Rejected variants of this tree's kernel: name -> source."""
    return {name: _substitute(src, pairs) for name, pairs in VARIANTS.items()}


# name -> [(text of this tree's fused_gapped.cu, replacement)]
VARIANTS = {
    # lanes a thread takes from a piece: 32 or 64 (16 kept)
    "v_lpt32": [("constexpr int LPT = 16;", "constexpr int LPT = 32;")],
    "v_lpt64": [("constexpr int LPT = 16;", "constexpr int LPT = 64;")],
    # threads a block: 128 or 512 (256 kept)
    "v_threads128": [("constexpr int THREADS = 256;",
                      "constexpr int THREADS = 128;")],
    "v_threads512": [("constexpr int THREADS = 256;",
                      "constexpr int THREADS = 512;")],
    # every cut read from device memory (L1), u8 rows unstaged too
    "v_unstaged": [("constexpr int STAGE_WORDS = 2048;",
                    "constexpr int STAGE_WORDS = 0;")],
    # packed rows staged as u8 rows are, where they fit
    "v_stage_packed": [
        ("  p.staged = !packed && words <= STAGE_WORDS;",
         "  p.staged = words <= STAGE_WORDS;"),
        ("  if (packed) return launch<SEG, true, false>(a, p, st, info);",
         "  if (packed)\n    return p.staged ? launch<SEG, true, true>(a, p, "
         "st, info)\n                    : launch<SEG, true, false>(a, p, "
         "st, info);")],
    # registers capped for 8 blocks an SM
    "v_8blocks": [("__launch_bounds__(THREADS)\nfused_gapped_kernel",
                   "__launch_bounds__(THREADS, 8)\nfused_gapped_kernel")],
    # every lane's windows cut anew
    "v_no_reuse": [("  const int reuse = 32 - (a.l_len > a.r_len ? a.l_len : "
                    "a.r_len);", "  const int reuse = 0;")],
    # a piece's counts gathered in the warp's shared memory, then stored
    # 16 bytes a thread
    "v_counts_buffer": [
        ("  rows.sm = mine + out_bytes(SEG) / 4;",
         "  int8_t* piece_counts = reinterpret_cast<int8_t*>(mine + "
         "out_bytes(SEG) / 4);\n  rows.sm = mine + (out_bytes(SEG) + SPAN) "
         "/ 4;"),
        ("        store_counts<SEG>(a.counts + g, cnt);",
         "        store_counts<SEG>(piece_counts + s * STEP + lane * SEG, "
         "cnt);"),
        ("          c = a.c_hi + 1;\n        }\n      }\n    }\n  }\n}\n",
         "          c = a.c_hi + 1;\n        }\n      }\n    }\n"
         "    __syncwarp();\n"
         "    const int64_t left = a.n - g0;\n"
         "    const int bytes = (int)(left < nsteps * STEP ? left : "
         "nsteps * STEP);\n"
         "    for (int i = 16 * lane; i < bytes; i += 16 * 32) {\n"
         "      if (i + 16 <= bytes) {\n"
         "        *reinterpret_cast<uint4*>(a.counts + g0 + i) =\n"
         "            *reinterpret_cast<const uint4*>(piece_counts + i);\n"
         "      } else {\n"
         "        for (int j = i; j < bytes; ++j) a.counts[g0 + j] = "
         "piece_counts[j];\n"
         "      }\n    }\n    __syncwarp();\n  }\n}\n"),
        ("  p.warp_bytes = out_bytes(seg) + (p.staged ?",
         "  p.warp_bytes = out_bytes(seg) + SPAN + (p.staged ?"),
        # shared memory takes no streaming hint
        ("  if constexpr (SEG == 2)\n    __stcs(reinterpret_cast<unsigned "
         "short*>(p), (unsigned short)w[0]);",
         "  if constexpr (SEG == 2) *reinterpret_cast<uint16_t*>(p) = "
         "(uint16_t)w[0];")],
    # seg 2's key planes and counts stored without the streaming hint
    "v_plain_stores": [
        ("            __stcs(reinterpret_cast<longlong2*>(a.hi + g) + j / 2,\n"
         "                   make_longlong2(kh[j], kh[j + 1]));\n"
         "            __stcs(reinterpret_cast<longlong2*>(a.lo + g) + j / 2,\n"
         "                   make_longlong2(kl[j], kl[j + 1]));",
         "            reinterpret_cast<longlong2*>(a.hi + g)[j / 2] =\n"
         "                make_longlong2(kh[j], kh[j + 1]);\n"
         "            reinterpret_cast<longlong2*>(a.lo + g)[j / 2] =\n"
         "                make_longlong2(kl[j], kl[j + 1]);"),
        ("  if constexpr (SEG == 2)\n    __stcs(reinterpret_cast<unsigned "
         "short*>(p), (unsigned short)w[0]);",
         "  if constexpr (SEG == 2) *reinterpret_cast<uint16_t*>(p) = "
         "(uint16_t)w[0];")],
    # spans of SPAN lanes walked grid-stride, not an even share of steps
    "v_spans": [("  for (int64_t s0 = first; s0 < last; s0 += STEPS) {\n"
                 "    const int64_t g0 = s0 * STEP;\n"
                 "    const int nsteps = (int)(last - s0 < STEPS ? last - s0 "
                 ": STEPS);",
                 "  for (int64_t s0 = gw * STEPS; s0 < steps; "
                 "s0 += warps * STEPS) {\n"
                 "    const int64_t g0 = s0 * STEP;\n"
                 "    const int nsteps = (int)(steps - s0 < STEPS ? "
                 "steps - s0 : STEPS);")],
    # key planes stored straight from registers at seg 4 too, or at every
    # seg (16-byte stores at a 16 seg-byte stride)
    "v_direct4": [("constexpr int DIRECT_SEG = 2;",
                   "constexpr int DIRECT_SEG = 4;")],
    "v_direct16": [("constexpr int DIRECT_SEG = 2;",
                    "constexpr int DIRECT_SEG = 16;")],
    # a thread's steps unrolled
    "v_unrolled": [("#pragma unroll 1\n    for (int s = 0; s < nsteps; ++s)",
                    "#pragma unroll 8\n    for (int s = 0; s < nsteps; ++s)")],
}


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
    for f in os.listdir(CSRC_DIR):
        if f.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, f)) as fh:
                text = fh.read()
            with open(os.path.join(AB_DIR, f), "w") as fh:
                fh.write(text)

    def put(name, text):
        path = os.path.join(AB_DIR, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        return path

    with open(os.path.join(other, "fused_gapped.cu")) as fh:
        other_src = fh.read()
    srcs = {"other": put("other", other_src + OTHER_INFO),
            "const_grid": put("const_grid", CONST_GRID),
            "store_floor": put("store_floor", STORE_FLOOR)}
    for name, text in other_variants(other_src).items():
        srcs[name] = put(name, text)
    builds = {"this": (os.path.join(CSRC_DIR, "fused_gapped.cu"),
                       os.path.join(BUILD_DIR, "libkmer_fused_gapped.so"))}
    for name, path in srcs.items():
        builds[name] = (path, os.path.join(AB_DIR, f"lib{name}.so"))
    if variants:
        with open(os.path.join(CSRC_DIR, "fused_gapped.cu")) as fh:
            for name, text in this_variants(fh.read()).items():
                builds[name] = (put(name, text),
                                os.path.join(AB_DIR, f"lib{name}.so"))
    t0 = time.time()
    procs = {k: subprocess.Popen([nvcc(), *NVCCFLAGS, "-Xptxas", "-v",
                                  "-shared", "-o", out, src],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, out) in builds.items()}
    logs, bad = {}, False
    for k, p in procs.items():
        logs[k] = p.communicate()[0]
        if p.returncode:
            say(f"build {k} failed:\n{logs[k][-4000:]}")
            bad = True
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
            if m and fn:
                name = re.search(r"(\w+)(<[^>]*>)?\(", fn)
                say(f"ptxas {k} {''.join(name.groups(''))}: {m.group(1)} "
                    f"registers, {spill} bytes spilled")
    return {k: out for k, (_, out) in builds.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other tree's kmer_tpu_torch/csrc")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--walls", action="store_true",
                    help="also time the gapped path end to end with each "
                    "tree's K3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        say("needs a CUDA device")
        return 2
    say(sh(["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"]).stdout.strip())
    libs = build_all(args.other, args.variants)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def stream():
        return torch.cuda.current_stream().cuda_stream

    launch_args = [vp, i32, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                   i32, i64, i64, i32, i32, vp]
    k3 = {"other": ctypes.CDLL(libs["other"]), "this": fg.load()}
    for name, so in libs.items():
        if name.startswith(("other_no_", "v_")):
            k3[name] = ctypes.CDLL(so)
    for lib in k3.values():
        lib.fused_gapped_count_launch.argtypes = launch_args
    k3["other"].other_info.argtypes = [i32, i32, i32, i32, i32, i32, i64, vp]
    const = ctypes.CDLL(libs["const_grid"])
    const.const_grid.argtypes = [vp, vp, vp, i32, i64, i32, vp]
    floor = ctypes.CDLL(libs["store_floor"])
    floor.store_floor.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    floor.floor_per_sm.argtypes = [vp]

    # ------------------------------------------------------------ inputs
    rng = np.random.default_rng(3)
    asym = dict(l_len=13, r_len=9, c_min=30, c_max=40)

    def case(B, L, win, packed, amb, short, seg, full_len=cs.GAP_LEN):
        host = cs.gapped_batch(rng, B, L, packed=packed, amb=amb,
                               short=short, full_len=full_len)
        kw = dict(win, mask_ambiguous=amb, seg=seg,
                  packed_width=L if packed else 0)
        return [t.to(dev) for t in host], kw

    timed = {
        "parity_packed_seg2": case(cs.GAP_B, cs.GAP_L, cs.GAP, True, False,
                                   False, 2),
        "u8_amb_512_seg2": case(512, cs.GAP_L, cs.GAP, False, True, False,
                                2),
        "packed_seg4": case(cs.GAP_B, cs.GAP_L, cs.GAP, True, False, False,
                            4),
        "packed_seg8": case(cs.GAP_B, cs.GAP_L, cs.GAP, True, False, False,
                            8),
        "u8_amb_seg16": case(512, cs.GAP_L, cs.GAP, False, True, True, 16),
        "asym_1024x160_seg4": case(1024, 160, asym, True, False, True, 4),
        "row_12288_x4": case(4, fg.MAX_ROW, cs.GAP, True, False, False, 2,
                             full_len=fg.MAX_ROW),
        "packed_2048_x64": case(64, 2048, cs.GAP, True, False, False, 2,
                                full_len=2048),
        "packed_4096_x16": case(16, 4096, cs.GAP, True, False, False, 2,
                                full_len=4096),
    }
    edges = {
        "c_max_gt_L": case(512, 120, cs.GAP, False, True, True, 16),
        "asym_u8_short": case(300, 64, asym, False, True, True, 16),
        "ragged_tail": case(3, 100, dict(l_len=5, r_len=4, c_min=10,
                                         c_max=90), True, False, True, 2),
        "tiny_rows": case(700, 12, dict(l_len=3, r_len=2, c_min=11,
                                        c_max=14), False, True, True, 2),
        "one_lane_rows": case(999, 90, dict(l_len=27, r_len=27, c_min=90,
                                            c_max=140), False, True, False,
                              2),
        "row_12288_u8_amb": case(2, fg.MAX_ROW, cs.GAP, False, True, True,
                                 16, full_len=fg.MAX_ROW),
        "near_12288_one_chunk": case(3, fg.MAX_ROW, dict(
            l_len=31, r_len=31, c_min=12200, c_max=12288), False, True,
            True, 4, full_len=fg.MAX_ROW),
    }

    def outputs(on_dev, kw):
        B = on_dev[0].shape[0]
        L = kw["packed_width"] or on_dev[0].shape[1]
        T = fg.gapped_lane_count(L, kw["c_min"], kw["c_max"])
        T_pad = -(-T // kw["seg"]) * kw["seg"]
        return (T, T_pad, [torch.empty((B, T_pad), dtype=torch.int64,
                                       device=dev) for _ in range(2)]
                + [torch.empty((B, T_pad), dtype=torch.int8, device=dev)])

    def k3_launcher(lib, on_dev, kw):
        codes, lengths, limits = on_dev
        B, L = codes.shape[0], kw["packed_width"] or codes.shape[1]
        T, T_pad, out = outputs(on_dev, kw)

        def fn():
            rc = lib.fused_gapped_count_launch(
                codes.data_ptr(), int(bool(kw["packed_width"])),
                codes.shape[1], lengths.data_ptr(), limits.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B,
                L, kw["l_len"], kw["r_len"], kw["c_min"], kw["c_max"], T,
                T_pad, int(kw["mask_ambiguous"]), kw["seg"], stream())
            assert rc == 0, rc
            return out
        return fn

    fails = 0
    for name, lib in k3.items():
        if name.startswith("other_no_"):
            continue
        worst = 0
        for cname, (on_dev, kw) in {**timed, **edges}.items():
            got = k3_launcher(lib, on_dev, kw)()
            torch.cuda.synchronize()
            want = fg.fused_gapped_count_ref(*on_dev, **kw)
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            if err:
                say(f"check K3 {name} case={cname} max_abs_err={err}")
            worst = max(worst, err)
        fails += worst != 0
        say(f"check K3 {name} cases={len(timed) + len(edges)} "
            f"max_abs_err={worst}")
    say(f"checks failed={fails}")
    if fails:
        return 1

    # ------------------------------------------------------------ geometry
    def info_of(lib, on_dev, kw):
        got = (ctypes.c_int * 7)()
        B, L = on_dev[0].shape[0], kw["packed_width"] or on_dev[0].shape[1]
        _, T_pad, _ = outputs(on_dev, kw)
        if lib is k3["other"]:
            lib.other_info(int(bool(kw["packed_width"])), kw["seg"], B, L,
                           kw["l_len"], kw["r_len"], T_pad, got)
            return dict(zip(INFO_KEYS, got))
        return fg.launch_info(B, L, **{k: kw[k] for k in (
            "l_len", "r_len", "c_min", "c_max", "seg", "mask_ambiguous")},
            packed=bool(kw["packed_width"]))

    for cname, (on_dev, kw) in timed.items():
        for name in ("other", "this"):
            if name == "this" and not hasattr(fg, "launch_info"):
                continue
            info = info_of(k3[name], on_dev, kw)
            say(f"launch {name} case={cname} " + " ".join(
                f"{k}={v}" for k, v in info.items()))
    per_sm = ctypes.c_int()
    floor.floor_per_sm(ctypes.byref(per_sm))
    say(f"floor blocks_per_sm={per_sm.value} sms={sms}")

    # ------------------------------------------------------------ timing
    def turns(label, fns):
        names = list(fns)
        got = {nm: [] for nm in names}
        for nm in names + names[::-1]:
            got[nm].append(cs.time_ms(fns[nm]))
        say(f"ab {label} " + " ".join(
            f"{nm}={got[nm][0]:.5f},{got[nm][1]:.5f}" for nm in names))

    hbm = cs.hbm_bytes_per_s(dev)
    for cname, (on_dev, kw) in timed.items():
        _, T_pad, _ = outputs(on_dev, kw)
        lanes = T_pad * on_dev[0].shape[0]
        turns(f"K3 {cname} lanes={lanes} out_MB={lanes * 17 / 1e6:.2f} "
              f"bound_ms={lanes * 17 / hbm * 1e3:.5f}",
              {nm: k3_launcher(lib, on_dev, kw) for nm, lib in k3.items()})
    for cname in ("parity_packed_seg2", "u8_amb_512_seg2"):
        on_dev, kw = timed[cname]
        B = on_dev[0].shape[0]
        L = kw["packed_width"] or on_dev[0].shape[1]
        _, T_pad, out = outputs(on_dev, kw)
        n = B * T_pad
        smem = info_of(k3["other"], on_dev, kw)["smem"]
        fns = {"const_grid": lambda: const.const_grid(
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B,
            T_pad, smem, stream())}
        for layout, lname in enumerate(("coalesced16", "runs16", "seg2")):
            fns[f"floor_{lname}"] = (
                lambda layout=layout: floor.store_floor(
                    out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                    n, sms * per_sm.value, layout, stream()))
        got = {nm: cs.time_ms(fn) for nm, fn in fns.items()}
        say(f"floors {cname} L={L} lanes={n} out_MB={n * 17 / 1e6:.2f} "
            + " ".join(f"{nm}={ms:.5f} ({n * 17 / ms / 1e9:.3f} TB/s)"
                       for nm, ms in got.items()))
    if args.walls:
        walls(dev, k3["other"], k3["this"])
    say("done")
    return 0


def walls(dev, other, this):
    """The gapped path end to end with either tree's K3 in the wrapper
    (everything else this tree's), in turns other, this, this, other:
    count_fasta on chip_smoke's 4000 reference-style records by sort,
    compact and device merge, and the parity dump of
    tests/data/sample.fasta (count + expand), each wall with its stages;
    every table must equal the first."""
    from kmer_tpu_torch import KmerConfig, count_fasta
    from kmer_tpu_torch.io.generator import reference_style_fasta
    from kmer_tpu_torch.pipeline.parity import SAMPLE_FASTA_MD5, parity_dump
    from kmer_tpu_torch.utils import stagetime
    cfg = KmerConfig(gapped=True, batch_reads=cs.GAP_B, max_read_len=512)
    runs = {"sort": cfg, "compact": cfg.replace(compact=True),
            "device_merge": cfg.replace(device_merge="on")}
    sample = os.path.join(cs.REPO, "tests", "data", "sample.fasta")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gapped.fasta")
        with open(path, "w") as f:
            f.write(reference_style_fasta(n_records=cs.GAP_RECORDS, seed=0))
        for run_cfg in runs.values():                   # warm-up, builds
            count_fasta(path, run_cfg, device=dev)
        parity_dump(sample, device=dev)
        want = None
        for turn, (name, lib) in enumerate(
                [("other", other), ("this", this), ("this", this),
                 ("other", other)]):
            fg._lib = lib
            for label, run_cfg in runs.items():
                times: dict[str, float] = {}
                torch.cuda.synchronize()
                with stagetime.collect(times):
                    table = count_fasta(path, run_cfg, device=dev)
                want = want or table
                if table != want:
                    raise AssertionError(f"{name} {label}: table differs")
                say(f"wall turn={turn} k3={name} run={label} "
                    f"wall_s={times['total']:.4f} stages_s="
                    + json.dumps({k: round(v, 4) for k, v in times.items()},
                                 sort_keys=True))
            t0 = time.perf_counter()
            dump = parity_dump(sample, device=dev)
            wall = time.perf_counter() - t0
            md5 = hashlib.md5(dump).hexdigest()
            if md5 != SAMPLE_FASTA_MD5:
                raise AssertionError(f"{name} parity md5 {md5}")
            say(f"wall turn={turn} k3={name} run=parity_count_expand "
                f"wall_s={wall:.4f} md5={md5}")
    fg._lib = this


if __name__ == "__main__":
    raise SystemExit(main())
