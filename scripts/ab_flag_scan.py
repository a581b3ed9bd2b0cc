"""A/B of the flag-scan kernels K4 (kmer_tpu_torch/csrc/compact.cu) and K2a
(the run lengths of kmer_tpu_torch/csrc/grouped_count.cu) against another
tree's, on one CUDA card.  Run from the repo root:

    mkdir -p _chip/parent
    git archive <commit> kmer_tpu_torch/csrc | tar -x -C _chip/parent
    PYTHONPATH=. python scripts/ab_flag_scan.py _chip/parent/kmer_tpu_torch/csrc [--variants]

It builds, all at once with nvcc -Xptxas -v: this tree's compact.cu and
grouped_count.cu (into kmer_tpu_torch/_build, where the wrappers load
them); the other tree's two files, its compact.cu with a count-only and a
scatter-only entry added (for a K4 of two launches); a store floor (the
same records written as constants, no loads); and with --variants this
tree's rejected K4 and K2a variants (text substitutions of compact.cu and
grouped_count.cu).  It prints each kernel's registers and spills,
compares the SASS of K2b/K2c (the *sort_kernel functions) of the two trees,
checks this tree's kernels and every variant against the plain versions
at the timed shapes and at edge cases, then times with CUDA events, the
trees in turns (other, this, variants..., variants..., this, other):
K4 at K1's main batch (k = 21, int8 counts), the unfused step's int32
counts and the gapped parity batch; the other tree's count and scatter
launches alone; the store floor; torch.masked_select of one key plane (a
yardstick, device kernels only); K2a at (4480, 256) W = 1 (the k = 21
unfused step), (3392, 256) W = 2 (k = 55) and other group sizes; K2b and
K2c (which must not move).  Builds of the other tree and the variants go
to kmer_tpu_torch/_build/ab/.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import chip_smoke as cs
from kmer_tpu_torch.ops.encode import SENTINEL_KEY
from kmer_tpu_torch.ops.kernels import compact as ck
from kmer_tpu_torch.ops.kernels import extract as ek
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.ops.kernels import fused_gapped as fg
from kmer_tpu_torch.ops.kernels import grouped_count as gk
from kmer_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR, NVCCFLAGS, nvcc

AB_DIR = os.path.join(BUILD_DIR, "ab")

# the other tree's K4 with its two launches callable one at a time
TWO_LAUNCH_ENTRIES = r'''
extern "C" int compact_count_only(const void* counts, int count_bytes,
                                  int64_t n, int32_t* block_live,
                                  void* stream) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 1)
    compact_count_kernel<int8_t><<<(unsigned)tiles, THREADS, 0, st>>>(
        static_cast<const int8_t*>(counts), n, block_live);
  else
    compact_count_kernel<int32_t><<<(unsigned)tiles, THREADS, 0, st>>>(
        static_cast<const int32_t*>(counts), n, block_live);
  return (int)cudaGetLastError();
}
extern "C" int compact_scatter_only(const int64_t* key0, const int64_t* key1,
                                    const void* counts, int count_bytes,
                                    int64_t n, int32_t* block_live, int mode,
                                    int s, int64_t* out_keys,
                                    int64_t* out_counts, int64_t* total,
                                    void* stream) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count_bytes == 1)
    compact_scatter_kernel<int8_t><<<(unsigned)tiles, THREADS, 0, st>>>(
        key0, key1, static_cast<const int8_t*>(counts), n, block_live, mode,
        s, out_keys, out_counts, total);
  else
    compact_scatter_kernel<int32_t><<<(unsigned)tiles, THREADS, 0, st>>>(
        key0, key1, static_cast<const int32_t*>(counts), n, block_live, mode,
        s, out_keys, out_counts, total);
  return (int)cudaGetLastError();
}
'''

STORE_FLOOR = r'''
#include <cstdint>
#include <cuda_runtime.h>
// constant records, no loads: block b writes rows [b per, (b + 1) per),
// consecutive threads on consecutive rows, 8-byte or 16-byte stores
__global__ void floor8(int64_t* keys, int64_t* counts, int64_t live,
                       int64_t per) {
  const int64_t b0 = blockIdx.x * per, e = b0 + per < live ? b0 + per : live;
  for (int64_t r = b0 + threadIdx.x; r < e; r += blockDim.x) {
    keys[r] = r;
    counts[r] = 1;
  }
}
__global__ void floor16(int64_t* keys, int64_t* counts, int64_t live,
                        int64_t per) {
  const int64_t b0 = blockIdx.x * per, e = b0 + per < live ? b0 + per : live;
  for (int64_t r = b0 + 2 * threadIdx.x; r + 1 < e; r += 2 * blockDim.x) {
    reinterpret_cast<longlong2*>(keys + r)[0] = make_longlong2(r, r + 1);
    reinterpret_cast<longlong2*>(counts + r)[0] = make_longlong2(1, 1);
  }
}
extern "C" int store_floor(int64_t* keys, int64_t* counts, int64_t live,
                           int blocks, int threads, int vec16, void* stream) {
  const int64_t per = ((live + blocks - 1) / blocks + 1) & ~1LL;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec16) floor16<<<blocks, threads, 0, st>>>(keys, counts, live, per);
  else floor8<<<blocks, threads, 0, st>>>(keys, counts, live, per);
  return (int)cudaGetLastError();
}
'''

# the look-back of one status word a lane that waits for the whole window
CLASSIC_LOOK_BACK = r'''__device__ int64_t look_back(const uint64_t* status, int64_t tile,
                             uint32_t epoch) {
  const int lane = threadIdx.x % 32;
  int64_t before = 0;
  for (int64_t pos = tile - 1;; pos -= 32) {
    const int64_t i = pos - lane;
    uint64_t w;
    uint64_t flag;
    do {
      w = i >= 0 ? load_status(status + i) : status_word(PREFIX, epoch, 0);
      flag = ((w >> VALUE_BITS) & EPOCH_MASK) == epoch ? w >> 62 : 0;
    } while (__any_sync(flag_scan::FULL, flag == 0));
    unsigned prefixes;
    const int nearer = flag_scan::ballot_rank(flag == PREFIX, prefixes);
    before += flag_scan::warp_sum(
        nearer == 0 ? (int64_t)(w & VALUE_MASK) : (int64_t)0);
    if (prefixes) return before;
  }
}

'''


# K4: prefetch into L2 the tile that blockIdx names, before the tile id
# comes back
PREFETCH = r'''
  {
    const int64_t guess = (int64_t)blockIdx.x * TILE;
    const int64_t lane_k = guess + (int64_t)threadIdx.x * 16;
    if (lane_k < n) {
      asm volatile("prefetch.global.L2 [%0];" :: "l"(key0 + lane_k));
      if constexpr (MODE != 0)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(key1 + lane_k));
    }
    const int64_t lane_c = guess + (int64_t)threadIdx.x * (128 / sizeof(C));
    if (lane_c < n && lane_c < guess + TILE)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(counts + lane_c));
  }
  __syncthreads();'''

# K2a: the warp's first row loads the row before it only after its own
# rows have arrived
LEFT_LATE = r'''  const int lane = threadIdx.x % 32;
  int64_t r[W][RL_ROWS];
  load_rows<W>(pl, first, n, vec, r);
  int64_t left[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    left[q] = __shfl_up_sync(flag_scan::FULL, r[q][RL_ROWS - 1], 1);
    if (lane == 0 && first > 0 && first < n)
      left[q] = __ldg(pl.w[q] + first - 1);
  }
'''


def k4_variants(src):
    """Rejected K4 variants: name -> source."""
    lb = src[src.index("__device__ int64_t look_back("):
             src.index("// the ITEMS counts of the lanes")]
    subs = {
        "k4_classic": [(lb, CLASSIC_LOOK_BACK)],
        "k4_look4": [("constexpr int LOOK = 1;", "constexpr int LOOK = 4;")],
        "k4_threads256": [
            ("constexpr int THREADS = 128;", "constexpr int THREADS = 256;"),
            ("static_assert(TILE == 2048", "static_assert(TILE > 0")],
        "k4_threads512": [
            ("constexpr int THREADS = 128;", "constexpr int THREADS = 512;"),
            ("static_assert(TILE == 2048", "static_assert(TILE > 0")],
        "k4_6blocks": [("__launch_bounds__(THREADS)\ncompact_kernel",
                        "__launch_bounds__(THREADS, MODE == 0 ? 6 : 4)\n"
                        "compact_kernel")],
        "k4_prefetch": [("    tile_s = (int64_t)t;\n  }\n  __syncthreads();",
                         "    tile_s = (int64_t)t;\n  }" + PREFETCH)],
        # a floor, not a kernel: each tile writes at its own lanes, with no
        # look-back (wrong records; timed only)
        "k4_no_look_back": [("      before = look_back(status, tile, epoch);",
                             "      before = tile * TILE;")],
    }
    return {name: _substitute(src, pairs) for name, pairs in subs.items()}


def k2a_variants(src):
    """Rejected K2a variants: name -> source."""
    early = src[src.index("  const int lane = threadIdx.x % 32;\n"
                          "  // the warp's first row loads"):
                src.index("  int pos = place(first, n, m);")]
    return {
        "k2a_rows2": _substitute(src, [("constexpr int RL_ROWS = 4;",
                                        "constexpr int RL_ROWS = 2;")]),
        "k2a_rows8": _substitute(src, [("constexpr int RL_ROWS = 4;",
                                        "constexpr int RL_ROWS = 8;")]),
        "k2a_left_late": _substitute(src, [(early, LEFT_LATE)]),
        "k2a_threads256": _substitute(src, [(
            "constexpr int RL_THREADS = 128;",
            "constexpr int RL_THREADS = 256;")]),
        "k2a_threads512": _substitute(src, [(
            "constexpr int RL_THREADS = 128;",
            "constexpr int RL_THREADS = 512;")]),
        "k2a_32registers": _substitute(src, [(
            "__launch_bounds__(RL_THREADS)\nrun_lengths_kernel",
            "__launch_bounds__(RL_THREADS, 16)\nrun_lengths_kernel")]),
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
    for f in ("flag_scan.cuh", "kmer_window.cuh"):
        if os.path.exists(os.path.join(CSRC_DIR, f)):
            with open(os.path.join(CSRC_DIR, f)) as fh:
                text = fh.read()
            with open(os.path.join(AB_DIR, f), "w") as fh:
                fh.write(text)
    srcs = {}

    def put(name, text):
        path = os.path.join(AB_DIR, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        return path

    with open(os.path.join(other, "compact.cu")) as fh:
        srcs["other_compact"] = put("other_compact",
                                    fh.read() + TWO_LAUNCH_ENTRIES)
    srcs["other_grouped"] = os.path.join(other, "grouped_count.cu")
    srcs["store_floor"] = put("store_floor", STORE_FLOOR)
    builds = {
        "compact": (os.path.join(CSRC_DIR, "compact.cu"),
                    os.path.join(BUILD_DIR, "libkmer_compact.so")),
        "grouped": (os.path.join(CSRC_DIR, "grouped_count.cu"),
                    os.path.join(BUILD_DIR, "libkmer_grouped_count.so")),
    }
    for name, path in srcs.items():
        builds[name] = (path, os.path.join(AB_DIR, f"lib{name}.so"))
    if variants:
        with open(os.path.join(CSRC_DIR, "compact.cu")) as fh:
            vk = k4_variants(fh.read())
        with open(os.path.join(CSRC_DIR, "grouped_count.cu")) as fh:
            vk.update(k2a_variants(fh.read()))
        for name, text in vk.items():
            builds[name] = (put(name, text),
                            os.path.join(AB_DIR, f"lib{name}.so"))
    t0 = time.time()
    procs = {k: subprocess.Popen([nvcc(), *NVCCFLAGS, "-Xptxas", "-v",
                                  "-shared", "-o", out, src],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, out) in builds.items()}
    # the kernels that make the inputs, at the same time
    others = [threading.Thread(target=f) for f in (fe.load, fg.load, ek.load)]
    for t in others:
        t.start()
    logs, bad = {}, False
    for k, p in procs.items():
        logs[k] = p.communicate()[0]
        if p.returncode:
            say(f"build {k} failed:\n{logs[k][-4000:]}")
            bad = True
    for t in others:
        t.join()
    say(f"builds done after {time.time() - t0:.1f} s ({len(builds)} libraries)")
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
            if m and fn and re.search(r"compact_kernel|run_lengths_kernel|"
                                      r"compact_scatter|compact_count", fn):
                say(f"ptxas {k} {fn.split('(')[0][-46:]}: {m.group(1)} "
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        say("needs a CUDA device")
        return 2
    say(sh(["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"]).stdout.strip())
    libs = build_all(args.other, args.variants)
    a, b = sass(libs["other_grouped"]), sass(libs["grouped"])
    for f in sorted(a):
        if "sort_kernel" in f:
            say(f"sass {f.split('(')[0][-40:]} same_as_other={a[f] == b.get(f)}"
                f" lines={len(a[f])}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ck.load()
    gk.load()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    other = ctypes.CDLL(libs["other_compact"])
    other.compact_launch.argtypes = [vp, vp, vp, i32, i64, vp, i32, i32, vp,
                                     vp, vp, vp]
    other.compact_count_only.argtypes = [vp, i32, i64, vp, vp]
    other.compact_scatter_only.argtypes = other.compact_launch.argtypes
    other_g = ctypes.CDLL(libs["other_grouped"])
    floor = ctypes.CDLL(libs["store_floor"])
    floor.store_floor.argtypes = [vp, vp, i64, i32, i32, i32, vp]
    k4 = {"this": ck.load()}
    k2a = {"this": gk.load(), "other": other_g}
    for name, so in libs.items():
        if name.startswith("k4_"):
            lib = ctypes.CDLL(so)
            lib.compact_launch.argtypes = ck.load().compact_launch.argtypes
            lib.compact_layout.argtypes = [vp]
            k4[name] = lib
        elif name.startswith("k2a_"):
            k2a[name] = ctypes.CDLL(so)
    for lib in k2a.values():
        lib.run_lengths_grouped_launch.argtypes = [vp] * 4 + [i32, i64, i32,
                                                              vp, vp]
        lib.grouped_sort_count_launch.argtypes = ([vp] * 8 + [i32, i64, i32,
                                                              i64, i64, vp,
                                                              vp])

    # ------------------------------------------------------------ inputs
    rng = np.random.default_rng(2)

    def batch(k):
        return [t.to(dev) for t in cs.kernel_batch(
            rng, cs.MAIN_B, cs.MAIN_L, k, packed=True, amb=False,
            short=False)]

    def k1_out(k):
        return fe.fused_extract_count(*batch(k), k, canonical=True,
                                      seg=cs.SEG, packed_width=cs.MAIN_L)

    from kmer_tpu_torch.ops import count as count_ops
    keys21 = ek.extract_keys(*batch(cs.K), cs.K, canonical=True,
                             packed_width=cs.MAIN_L)
    (flat,), counts32 = count_ops.grouped_count([keys21], 256,
                                                backend="hybrid")
    gap = [t.to(dev) for t in cs.gapped_batch(rng, cs.GAP_B, cs.GAP_L,
                                              packed=True, amb=False,
                                              short=False)]
    hi, lo, gcounts = fg.fused_gapped_count(*gap, **cs.GAP, seg=cs.SEG,
                                            packed_width=cs.GAP_L)
    keys, counts = k1_out(cs.K)
    timed = {
        "k1_main": ([keys], counts, {}),
        "unfused_int32": ([flat], counts32, {}),
        "k3_parity": ([hi, lo], gcounts, dict(r_len=27, n_bases=54)),
    }
    T = ck.TILE

    def lanes(n, share, dtype=np.int8):
        c = ((rng.random(n) < share) * rng.integers(1, 100, n)).astype(dtype)
        return ([torch.from_numpy(rng.integers(0, 1 << 62, n)).to(dev)],
                torch.from_numpy(c).to(dev), {})

    edges = {"one_lane": lanes(1, 1.0), "tile_minus_1": lanes(T - 1, 0.5),
             "tile": lanes(T, 0.5), "tile_plus_1": lanes(T + 1, 0.5),
             "all_live_40_tiles": lanes(40 * T, 1.0),
             "int32_tail": lanes(12345, 0.6, np.int32)}
    p, c, _ = lanes(10 * T + 37, 0.0)
    c[-5] = 3
    edges["one_live_in_last_tile"] = (p, c, {})
    p, c, _ = lanes(21 * T, 0.7)
    c.view(21, T)[1::2] = 0
    edges["every_other_tile"] = (p, c, {})
    for k in (cs.WIDE_K, 63):
        keys, counts = k1_out(k)
        edges[f"k1_pair_k{k}"] = (list(keys), counts,
                                  dict(r_len=k - 31, n_bases=k))
    edges.update(timed)

    def k4_launcher(lib, planes, counts, kw):
        """A closure that launches lib's K4 on preallocated outputs (the
        other tree's with its block_live scratch, this tree's with its
        scratch and a new epoch a call)."""
        n = counts.numel()
        mode = ck._mode(planes, kw.get("r_len", 0), kw.get("n_bases", 0))
        out = (torch.empty((n, 2) if mode == 2 else (n,), dtype=torch.int64,
                           device=dev),
               torch.empty(n, dtype=torch.int64, device=dev),
               torch.zeros(1, dtype=torch.int64, device=dev))
        common = (planes[0].data_ptr(), planes[-1].data_ptr(),
                  counts.data_ptr(), counts.element_size(), n)
        tail = (mode, 2 * kw.get("r_len", 0), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr())
        if lib is other:
            scratch = torch.empty(-(-n // 4096), dtype=torch.int32,
                                  device=dev)

            def fn(part="all"):
                assert scratch is not None
                if part == "count":
                    rc = other.compact_count_only(
                        counts.data_ptr(), counts.element_size(), n,
                        scratch.data_ptr(), stream())
                else:
                    entry = (other.compact_launch if part == "all"
                             else other.compact_scatter_only)
                    rc = entry(*common, scratch.data_ptr(), *tail, stream())
                assert rc == 0, rc
                return out
            return fn
        layout = (ctypes.c_int32 * 2)()
        lib.compact_layout(ctypes.addressof(layout))
        scratch = torch.zeros(1 + -(-n // layout[0]), dtype=torch.int64,
                              device=dev)
        epoch = [0]

        def fn():
            epoch[0] += 1
            assert lib.compact_launch(*common, scratch.data_ptr(), epoch[0],
                                      *tail, stream()) == 0
            return out
        return fn

    def k4_err(got, want):
        t = int(want[2][0])
        err = abs(int(got[2][0]) - t)
        if t:
            err = max(err, int((got[0][:t] - want[0][:t]).abs().max()),
                      int((got[1][:t] - want[1][:t]).abs().max()))
        return err

    fails = 0
    for name, lib in k4.items():
        if name == "k4_no_look_back":
            continue
        worst = 0
        for case, (planes, counts, kw) in edges.items():
            got = k4_launcher(lib, planes, counts, kw)()
            torch.cuda.synchronize()
            worst = max(worst, k4_err(got, ck.compact_ref(planes, counts,
                                                          **kw)))
        fails += worst != 0
        say(f"check K4 {name} cases={len(edges)} max_abs_err={worst}")

    # K2a inputs: sorted groups
    gen = torch.Generator(device=dev).manual_seed(12)

    def rows(shape, W, hi=3, dead=0.2):
        planes = [torch.randint(0, hi, shape, generator=gen, device=dev)
                  for _ in range(W)]
        gone = torch.rand(shape, generator=gen, device=dev) < dead
        return gk.sort_groups([torch.where(gone, SENTINEL_KEY, p)
                               for p in planes])

    wide = [w.reshape(-1) for w in ek.extract_keys(
        *batch(cs.WIDE_K), cs.WIDE_K, canonical=True,
        packed_width=cs.MAIN_L)]
    pad = -wide[0].numel() % 256
    groups = {
        "route_w1": gk.sort_groups([flat.view(-1, 256)]),
        "k55_w2": gk.sort_groups([torch.cat([w, torch.full(
            (pad,), SENTINEL_KEY, device=dev)]).view(-1, 256) for w in wide]),
    }
    # any m at the main batch's 1,146,880 rows, and small streams of
    # 300,000 rows at W = 1 or 150,000 at W = 2
    for m in (1, 3, 33, 128, 1000, 4096):
        groups[f"m{m}_w1"] = rows((max(1, 1_146_880 // m), m), 1)
    for m, W in ((1, 1), (3, 1), (128, 2)):
        groups[f"small_m{m}_w{W}"] = rows((300_000 // (m * W), m), W)
    groups["m4096_w4"] = rows((70, 4096), 4)
    x = torch.full((5, 4096), 9, device=dev)
    x[:, 1000:3000] = 11
    x[:, 3000:] = SENTINEL_KEY
    groups["run_over_tile_end"] = [x, x.clone()]
    groups["fill_group"] = [torch.full((6, 4096), 7, device=dev)]
    groups["sentinel_groups"] = rows((64, 256), 2, dead=1.0)

    def k2a_launcher(lib, planes):
        G, m = planes[0].shape
        out = torch.empty((G, m), dtype=torch.int32, device=dev)
        ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))

        def fn():
            assert lib.run_lengths_grouped_launch(
                *ptrs, len(planes), G, m, out.data_ptr(), stream()) == 0
            return out
        return fn

    for name, lib in k2a.items():
        if name == "other":
            continue
        worst = 0
        for planes in groups.values():
            got = k2a_launcher(lib, planes)()
            torch.cuda.synchronize()
            worst = max(worst, int((got.long() - gk.run_lengths_grouped_ref(
                planes).long()).abs().max()))
        fails += worst != 0
        say(f"check K2a {name} cases={len(groups)} max_abs_err={worst}")
    say(f"checks failed={fails}")
    if fails:
        return 1

    # ------------------------------------------------------------ timing
    def turns(label, fns):
        names = list(fns)
        got = {nm: [] for nm in names}
        for nm in names + names[::-1]:
            got[nm].append(cs.time_ms(fns[nm]))
        say(f"ab {label} " + " ".join(
            f"{nm}={got[nm][0]:.5f},{got[nm][1]:.5f}" for nm in names))

    for name, (planes, counts, kw) in timed.items():
        fns = {"other": k4_launcher(other, planes, counts, kw)}
        fns.update({k: k4_launcher(lib, planes, counts, kw)
                    for k, lib in k4.items()})
        turns(f"K4 {name} lanes={counts.numel()} "
              f"live={int((counts > 0).sum())}", fns)
        parts = k4_launcher(other, planes, counts, kw)
        parts("count")
        turns(f"K4 {name} other_parts",
              {"count_only": lambda: parts("count"),
               "scatter_only": lambda: parts("scatter")})
        yard = cs.device_kernel_ms(lambda: [torch.masked_select(
            planes[0], counts > 0) for _ in range(10)])
        say(f"yardstick K4 {name} masked_select_one_plane_ms="
            f"{sum(v[0] for v in yard.values()) / 10:.5f} (device kernels)")
    planes, counts, _ = timed["k1_main"]
    live, n = int((counts > 0).sum()), counts.numel()
    fk = torch.empty(n, dtype=torch.int64, device=dev)
    fc = torch.empty(n, dtype=torch.int64, device=dev)
    for blocks, threads in ((281, 256), (132, 1024), (1056, 256)):
        for v16 in (0, 1):
            ms = cs.time_ms(lambda: floor.store_floor(
                fk.data_ptr(), fc.data_ptr(), live, blocks, threads, v16,
                stream()))
            say(f"store_floor k1_main records={live} blocks={blocks} "
                f"threads={threads} vec16={v16} ms={ms:.5f} "
                f"GB_per_s={live * 16 / ms / 1e6:.1f}")
    for name, planes in groups.items():
        turns(f"K2a {name} shape={tuple(planes[0].shape)} W={len(planes)}",
              {"other": k2a_launcher(other_g, planes),
               **{k: k2a_launcher(lib, planes) for k, lib in k2a.items()
                  if k != "other"}})

    def sort_launcher(lib, planes, strided):
        if strided:
            m, G = planes[0].shape
            es, gs = G, 1
        else:
            G, m = planes[0].shape
            es, gs = 1, m
        outs = [torch.empty_like(p) for p in planes]
        cnt = torch.empty(planes[0].shape, dtype=torch.int32, device=dev)
        ptr = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
        optr = [p.data_ptr() for p in outs] + [None] * (4 - len(planes))

        def fn():
            assert lib.grouped_sort_count_launch(
                *ptr, *optr, len(planes), G, m, es, gs, cnt.data_ptr(),
                stream()) == 0
            return outs, cnt
        return fn

    for label, planes, strided in (("K2b", [flat.view(-1, 256)], False),
                                   ("K2c", [flat.view(16, -1)], True)):
        turns(f"{label} shape={tuple(planes[0].shape)}",
              {"other": sort_launcher(other_g, planes, strided),
               "this": sort_launcher(gk.load(), planes, strided)})
    say("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
