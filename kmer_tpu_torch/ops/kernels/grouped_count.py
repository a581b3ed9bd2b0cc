"""Grouped run lengths (K2a) and grouped sort + run lengths over contiguous
(K2b) or strided-column (K2c) groups, as three entry points of one
hand-written Hopper kernel source (csrc/grouped_count.cu), each with its
plain torch version.

Counterparts of kmer_tpu/ops/pallas/fused_count.py
`run_lengths_grouped_pallas` (K2a), `fused_grouped_count` (K2b) and
`fused_grouped_count_sublane` (K2c).  kmer_tpu works on repacked uint32
words and sorts by word 0 alone, so equal keys may stay apart after its
sort; here a row is W int64 words (ops/encode; any W up to MAX_WORDS for
K2a, any W whose group fits a block's shared memory for K2b and K2c,
max_group_rows), compared
lexicographically with SENTINEL_KEY rows (dead lanes, word 0 ==
SENTINEL_KEY) last, and K2b/K2c sort by ALL words.  Their sorted groups
are therefore exact and equal the plain version's stable sort bit for bit.

Count contract of all three: within a group, a run of equal rows has its
length (int32) at its first row; every other row, and every dead run,
has 0.

- run_lengths_grouped(planes (G, m)) -> counts (G, m), planes already
  sorted within each group; any m.
- grouped_count(planes (G, m)) -> (sorted planes, counts), each row a
  group; m a power of two up to max_group_rows(W).
- grouped_count_strided(planes (m, G)) -> the same for the groups that
  are the COLUMNS of the (m, G) array (element i of group g at
  i * G + g), in the same layout.

Each dispatches on where its inputs lie: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise).  An empty input
launches nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..encode import SENTINEL_KEY

SOURCE = "kmer_tpu_torch/csrc/grouped_count.cu"
REPLACES_RUN_LENGTHS = "kmer_tpu/ops/pallas/fused_count.py:175"
REPLACES_GROUPED = "kmer_tpu/ops/pallas/fused_count.py:208"
REPLACES_STRIDED = "kmer_tpu/ops/pallas/fused_count.py:241"
MAX_WORDS = 128                 # csrc/grouped_count.cu MAX_PLANES
# K2b/K2c's bodies, by the index csrc/grouped_count.cu's launch report
# gives: a thread per strided column of m <= 32 rows, a warp per span of
# contiguous groups of m <= 1024 rows, a block per group tile in shared
# memory for every other shape
BODIES = ("column", "warp", "block")
# shared memory a block may take (csrc/grouped_count.cu SMEM_MAX)
SMEM_BYTES = 232448
# kernel launches by entry point (the plain versions on CPU tensors do not
# count)
run_lengths_launches = 0
grouped_launches = 0
strided_launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "grouped_count.cu"),
                         "kmer_grouped_count", cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.run_lengths_grouped_launch.restype = i
        lib.run_lengths_grouped_launch.argtypes = [vp, i, i64, i, vp, vp]
        lib.grouped_sort_count_launch.restype = i
        lib.grouped_sort_count_launch.argtypes = [vp, vp, i, i64, i, i64, i64,
                                                  vp, vp]
        lib.grouped_sort_info.restype = i
        lib.grouped_sort_info.argtypes = [i, i64, i, i64, i64, vp]
        if lib.grouped_max_planes() != MAX_WORDS:
            raise RuntimeError(f"grouped_count.cu takes "
                               f"{lib.grouped_max_planes()} planes, this "
                               f"wrapper {MAX_WORDS}")
        _lib = lib
    return _lib


def launch_info(G: int, m: int, n_words: int = 1, *,
                strided: bool = False) -> dict:
    """The launch grouped_count (strided=False) or grouped_count_strided
    (strided=True) makes for G groups of m rows of n_words words on the
    current CUDA device, without making it: the body (one of BODIES),
    threads a block, blocks, dynamic shared bytes, registers a thread,
    spill bytes, resident blocks an SM."""
    _check_pow2(m, n_words)
    info = (ctypes.c_int * 8)()
    es, gs = (G, 1) if strided else (1, m)
    rc = load().grouped_sort_info(n_words, G, m, es, gs, info)
    if rc != 0:
        raise RuntimeError(f"grouped sort launch report failed: cudaError "
                           f"{rc}")
    out = dict(zip(("threads", "blocks", "smem", "registers", "spill_bytes",
                    "blocks_per_sm"), info[:6]))
    return {"body": BODIES[info[7]], **out}


def max_group_rows(n_words: int) -> int:
    """The largest group K2b/K2c sort: the power of two m whose m rows of
    n_words int64 words fit a block's shared memory (16384 rows at W = 1,
    4096 at W = 4, 2048 at W = 5)."""
    m = 1
    while 2 * m * n_words * 8 <= SMEM_BYTES:
        m *= 2
    return m


def _check(planes) -> list[torch.Tensor]:
    planes = list(planes)
    if not 1 <= len(planes) <= MAX_WORDS:
        raise ValueError(f"grouped counts take 1 to {MAX_WORDS} word planes, "
                         f"got {len(planes)}")
    p0 = planes[0]
    for p in planes:
        if (p.dim() != 2 or p.dtype != torch.int64 or p.device != p0.device
                or p.shape != p0.shape or not p.is_contiguous()):
            raise ValueError("word planes must be contiguous 2-D int64 "
                             "tensors of one shape on one device")
    return planes


def _check_pow2(m: int, n_words: int) -> None:
    if m & (m - 1) or not 1 <= m <= max_group_rows(n_words):
        raise ValueError(f"group size {m} must be a power of two <= "
                         f"{max_group_rows(n_words)} at W={n_words}")


def _ptrs(planes):
    """The planes' device pointers as a C array."""
    return (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])


def _device(planes) -> torch.device | None:
    """None for CPU planes (the plain version), else the CUDA device."""
    dev = planes[0].device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no grouped count on {dev}")
    return dev


def sort_groups(planes) -> list[torch.Tensor]:
    """Each row of the (G, m) planes sorted lexicographically (word 0 most
    significant): W stable torch.sort calls along dim 1, from the last
    word to the first, each gathering every word.  Plain torch on any
    device (the hybrid backend's sort)."""
    out = _check(planes)
    for q in range(len(out) - 1, -1, -1):
        order = torch.sort(out[q], dim=1, stable=True).indices
        out = [torch.take_along_dim(w, order, dim=1) for w in out]
    return out


def run_lengths_grouped_ref(planes) -> torch.Tensor:
    """Plain torch version of K2a: run starts by the neighbour compare,
    the next start by a reverse cummin along each group."""
    planes = _check(planes)
    G, m = planes[0].shape
    dev = planes[0].device
    start = torch.zeros((G, m), dtype=torch.bool, device=dev)
    start[:, 0] = True
    for w in planes:
        start[:, 1:] |= w[:, 1:] != w[:, :-1]
    idx = torch.arange(m, dtype=torch.int32, device=dev).expand(G, m)
    start_pos = torch.where(start, idx, m)
    suffix = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    next_start = torch.cat([suffix[:, 1:],
                            torch.full((G, 1), m, dtype=torch.int32,
                                       device=dev)], dim=1)
    live = start & (planes[0] != SENTINEL_KEY)
    return torch.where(live, next_start - idx, 0).to(torch.int32)


def run_lengths_grouped(planes) -> torch.Tensor:
    """Counts (G, m) int32 of group-sorted (G, m) int64 planes (K2a)."""
    planes = _check(planes)
    dev = _device(planes)
    if dev is None:
        return run_lengths_grouped_ref(planes)
    G, m = planes[0].shape
    counts = torch.empty((G, m), dtype=torch.int32, device=dev)
    if counts.numel() == 0:
        return counts
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.run_lengths_grouped_launch(
            _ptrs(planes), len(planes), G, m, counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"run_lengths_grouped kernel launch failed: "
                           f"cudaError {rc}")
    global run_lengths_launches
    run_lengths_launches += 1
    return counts


def grouped_count_ref(planes):
    """Plain torch version of K2b: sort_groups, then
    run_lengths_grouped_ref."""
    s = sort_groups(planes)
    return s, run_lengths_grouped_ref(s)


def grouped_count_strided_ref(planes):
    """Plain torch version of K2c: grouped_count_ref over the columns."""
    planes = _check(planes)
    s, counts = grouped_count_ref([p.T.contiguous() for p in planes])
    return [w.T.contiguous() for w in s], counts.T.contiguous()


def _launch_sort(planes, G: int, m: int, elem_stride: int,
                 group_stride: int, dev):
    out = [torch.empty_like(p) for p in planes]
    counts = torch.empty(planes[0].shape, dtype=torch.int32, device=dev)
    if counts.numel() == 0:
        return out, counts, False
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.grouped_sort_count_launch(
            _ptrs(planes), _ptrs(out), len(planes), G, m, elem_stride,
            group_stride, counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped sort kernel launch failed: "
                           f"cudaError {rc}")
    return out, counts, True


def grouped_count(planes):
    """(G, m) int64 planes -> (each row sorted, counts (G, m) int32) (K2b);
    m a power of two <= max_group_rows(W)."""
    planes = _check(planes)
    G, m = planes[0].shape
    _check_pow2(m, len(planes))
    dev = _device(planes)
    if dev is None:
        return grouped_count_ref(planes)
    out, counts, launched = _launch_sort(planes, G, m, 1, m, dev)
    global grouped_launches
    grouped_launches += launched
    return out, counts


def grouped_count_strided(planes):
    """(m, G) int64 planes -> (each column sorted, counts (m, G) int32)
    (K2c); m a power of two <= max_group_rows(W)."""
    planes = _check(planes)
    m, G = planes[0].shape
    _check_pow2(m, len(planes))
    dev = _device(planes)
    if dev is None:
        return grouped_count_strided_ref(planes)
    out, counts, launched = _launch_sort(planes, G, m, G, 1, dev)
    global strided_launches
    strided_launches += launched
    return out, counts
