"""Stable multi-word sort of int64 word planes, as one hand-written
Hopper kernel (csrc/sort.cu, a hybrid MSD radix sort) and its plain torch
version.

Counterpart of kmer_tpu/ops/pallas/sort.py `sort_words_pallas`: W (up to
MAX_WORDS) equal-length rows of words, sorted by their first `num_keys`
words (word 0 most significant), duplicates kept; the other words are
payload, and rows with equal keys keep their input order.  kmer_tpu
sorts W uint32 words; here a word is an int64 compared as signed, so the
sentinel SENTINEL = INT64_MAX sorts last.

`bits[q]` promises that key word q holds values in [0, 2**bits[q]) or
SENTINEL; 64 (the default) means any int64.  The kernel splits the rows
by 8-bit digits of the key words' codes (bits + 1 significant bits, 64
at 64) from the most significant down: level 0 by the top digit of word
0 over every row, each later level only the buckets of more than
LOCAL_ROWS rows whose codes still vary, by the 8-bit window under their
highest varying bit; buckets of at most LOCAL_ROWS rows are sorted whole
in shared memory and written once, and a bucket in which nothing varies
is done where it stands.  So a caller that knows its key's width passes
it: the levels, and with them the launches (plan()), follow from the
bits.  The plain version checks the promise on CPU tensors.

sort_words dispatches on where its inputs lie: CPU tensors run the
plain version and return new tensors; CUDA tensors launch the kernel,
which sorts them IN PLACE and returns them (or raises).  The launch never
waits on the device.  No row count is too small for the kernel, and an
empty input launches nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...utils import stagetime

SOURCE = "kmer_tpu_torch/csrc/sort.cu"
REPLACES = "kmer_tpu/ops/pallas/sort.py:134"
MAX_WORDS = 240                            # csrc/sort.cu MAX_PLANES
SENTINEL = torch.iinfo(torch.int64).max    # the padding word: sorts last
TILE_ROWS = 4096                           # rows a scatter tile of sort.cu
RUN_ROWS = 4096                            # a hist / scatter block's run
LOCAL_ROWS = 8192                          # rows a local tile at most
MAX_ROWS = 1 << 40                         # rows the kernel takes
BINS = 256                                 # 8-bit digits
PLAN_KEYS = ("levels", "launches", "tile_rows", "run_rows", "local_rows",
             "cap_buckets", "cap_runs", "cap_tiles", "rec_words",
             "scratch_words")
# calls of sort_words that launched the kernel (the plain version on CPU
# tensors does not count)
launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "sort.cu"), "kmer_sort",
                         cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sort_words_launch.restype = i
        lib.sort_words_launch.argtypes = [vp, i, i, vp, i64, vp, vp]
        lib.sort_scratch_words.restype = i64
        lib.sort_scratch_words.argtypes = [i, i, vp, i64]
        lib.sort_plan.restype = i
        lib.sort_plan.argtypes = [i, i, vp, i64, vp]
        lib.sort_launch_info.restype = i
        lib.sort_launch_info.argtypes = [i, i, vp, i64, vp]
        got = (lib.sort_tile_rows(), lib.sort_run_rows(),
               lib.sort_local_rows(), lib.sort_max_planes())
        want = (TILE_ROWS, RUN_ROWS, LOCAL_ROWS, MAX_WORDS)
        if got != want:
            raise RuntimeError(f"sort.cu has (TILE, RUN_ROWS, LOCAL, "
                               f"MAX_PLANES) = {got}, this wrapper {want}")
        for n, W, bits in ((1, 1, (0,)), (LOCAL_ROWS + 1, 2, (42,)),
                           (25_165_824, 3, (62, 48)),
                           (12_582_912, 5, (62, 62, 62, 16)),
                           (50_000, MAX_WORDS, (64,) * 7)):
            mine = plan(n, W, len(bits), bits)
            theirs = _plan_of(lib, n, W, bits)
            if mine != theirs:
                raise RuntimeError(f"sort.cu plans {theirs} for {(n, W, bits)}"
                                   f", this wrapper {mine}")
        _lib = lib
    return _lib


def _c_bits(bits):
    return (ctypes.c_int * len(bits))(*bits)


def _plan_of(lib, n, W, bits) -> dict:
    out = (ctypes.c_int64 * len(PLAN_KEYS))()
    rc = lib.sort_plan(W, len(bits), _c_bits(bits), n, out)
    if rc != 0:
        raise RuntimeError(f"sort plan failed: cudaError {rc}")
    return dict(zip(PLAN_KEYS, out))


def plan(n: int, W: int, num_keys: int, bits, *,
         local_rows: int = LOCAL_ROWS, run_rows: int = RUN_ROWS) -> dict:
    """What one kernel call on n rows of W planes, num_keys key words of
    these bits, makes and takes (csrc/sort.cu's plan_of, which load()
    holds it against): the MSD levels (the sum over the key words of
    ceil(significant bits / 8); no row is split more often), the launches
    (four a level less level 0's reduce, and the local sort but for a
    plan of one level, whose scatter leaves it nothing), the
    tile, run and local-tile rows, the work lists' capacities (buckets of
    more than LOCAL_ROWS rows a level, their runs of RUN_ROWS rows, the
    local tiles over all levels), a bucket record's words and the int64
    words of scratch: a second set of planes, the digit-major run counts,
    the lists and the counters.  Other local_rows and run_rows size a
    model of the kernel at small scale (tests/test_torch_sort_msd.py)."""
    bits = tuple(bits)[:num_keys]
    levels = sum(((b + 1 if b < 64 else 64) + 7) // 8 for b in bits)
    cap_b = n // (local_rows + 1) + 1
    cap_r = n // run_rows + cap_b + 1
    cap_t = 2 * (n // local_rows + 1) + 4 * levels * cap_b
    rec = 5 + 2 * num_keys
    n_ctr = 2 * (levels + 1) + 1
    words = (W * n + BINS * (cap_r + 1) + 2 * cap_r + 2 * cap_b * rec
             + 2 * cap_t + n_ctr)
    launches = 4 * levels - int(levels == 1)
    return dict(zip(PLAN_KEYS, (levels, launches, TILE_ROWS, run_rows,
                                local_rows, cap_b, cap_r, cap_t, rec,
                                words)))


def launch_info(n: int, W: int, num_keys=None, bits=None) -> dict:
    """plan() with the launches the kernel makes for the shape on the
    current CUDA device, without making them: the grids (reduce and hist
    four blocks an SM, scatter three, local two; a block a run or local
    tile at most), threads, dynamic shared bytes, and the scatter and
    local kernels' registers, spill bytes and resident blocks an SM, and
    the planes of the parameter struct."""
    num_keys = W if num_keys is None else num_keys
    bits = (64,) * num_keys if bits is None else tuple(bits)
    out = (ctypes.c_int64 * 15)()
    rc = load().sort_launch_info(W, num_keys, _c_bits(bits), n, out)
    if rc != 0:
        raise RuntimeError(f"sort launch report failed: cudaError {rc}")
    keys = ("run_grid", "scatter_grid", "local_grid", "threads",
            "local_threads", "scatter_smem", "local_smem", "scan_threads",
            "scatter_registers",
            "scatter_spill_bytes", "scatter_blocks_per_sm",
            "local_registers", "local_spill_bytes", "local_blocks_per_sm",
            "param_planes")
    return {"body": "msd", **plan(n, W, num_keys, bits),
            **dict(zip(keys, out))}


def _check(words, num_keys, bits):
    """(planes, num_keys, bits as a tuple of num_keys ints)."""
    words = list(words)
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"sort_words takes 1 to {MAX_WORDS} word planes, "
                         f"got {len(words)}")
    w0 = words[0]
    for w in words:
        if (w.dim() != 1 or w.dtype != torch.int64 or w.device != w0.device
                or w.shape != w0.shape or not w.is_contiguous()):
            raise ValueError("word planes must be contiguous 1-D int64 "
                             "tensors of one length on one device")
    num_keys = len(words) if num_keys is None else int(num_keys)
    if not 1 <= num_keys <= len(words):
        raise ValueError(f"num_keys={num_keys} not in 1..{len(words)}")
    bits = (64,) * num_keys if bits is None else tuple(int(b) for b in bits)
    if len(bits) != num_keys or not all(0 <= b <= 64 for b in bits):
        raise ValueError(f"bits={bits} must give 0..64 for each of the "
                         f"{num_keys} key words")
    return words, num_keys, bits


def _check_bits(words, bits) -> None:
    """Raise when a CPU key word breaks its bits promise."""
    for q, (w, b) in enumerate(zip(words, bits)):
        if b == 64 or w.device.type != "cpu":
            continue
        bad = (w < 0) if b == 63 else ((w < 0) | (w >= 1 << b))
        if bool((bad & (w != SENTINEL)).any()):
            raise ValueError(f"key word {q} holds values outside "
                             f"[0, 2**{b}) that are not the sentinel")


def sort_words_ref(words, num_keys=None, bits=None) -> list[torch.Tensor]:
    """Plain torch version: stable sorts of the key words, from the last
    to the first, each gathering every word."""
    out, num_keys, bits = _check(words, num_keys, bits)
    _check_bits(out[:num_keys], bits)
    for q in range(num_keys - 1, -1, -1):
        order = torch.sort(out[q], stable=True).indices
        out = [w[order] for w in out]
    return out


def sort_words(words, num_keys=None, bits=None) -> list[torch.Tensor]:
    """The W word planes (1-D int64, equal length) sorted stably by their
    first num_keys words (default all), word 0 most significant; in place
    on a GPU.  bits: the key words' value bits (default 64 each).  Inside
    an `op::K6` range while a profiler records (utils/stagetime.span)."""
    with stagetime.span("op::K6"):
        return _sort_words(words, num_keys, bits)


def _sort_words(words, num_keys, bits) -> list[torch.Tensor]:
    words, num_keys, bits = _check(words, num_keys, bits)
    dev = words[0].device
    if dev.type == "cpu":
        return sort_words_ref(words, num_keys, bits)
    if dev.type != "cuda":
        raise ValueError(f"no sort_words on {dev}")
    n = words[0].numel()
    if n == 0:
        return words
    if n > MAX_ROWS:
        raise ValueError(f"sort_words takes at most {MAX_ROWS} rows on a "
                         f"GPU, got {n}")
    W = len(words)
    ptrs = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
    lib = load()
    c_bits = _c_bits(bits)
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.sort_scratch_words(W, num_keys, c_bits, n),
                              dtype=torch.int64, device=dev)
        rc = lib.sort_words_launch(ptrs, W, num_keys, c_bits, n,
                                   scratch.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return words
