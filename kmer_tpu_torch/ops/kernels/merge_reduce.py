"""Run totals and compaction of the device merge (ops/devmerge): the
R = C + N rows of one merge, sorted by their W int64 key words with the
counts riding along, reduced to one row a distinct real key with its
run's total, compacted to the front of a new C-row state, as one
hand-written Hopper kernel (csrc/merge_reduce.cu) and its plain torch
version.

Replaces no Pallas kernel: kmer_tpu's merge takes its run totals from
XLA (a cumsum and a backward lax.cummin, kmer_tpu/ops/devmerge.py:91-97).
merge_reduce_ref is that tail in plain torch, the form this port ran on
every device before the kernel; it stays as the CPU twin.

Contract (both versions): words, W sorted (C + N,) int64 planes, and
counts (C + N,) int64, as ops/count.sort_words leaves them; a run is a
maximal group of equal rows, real when its word 0 is not SENTINEL.
Returns (new_words, new_counts, distinct): W (C,) int64 planes and (C,)
int64 counts holding each real run's words and total in key order in
rows [0, distinct), SENTINEL / 0 past them, and distinct, the number of
real runs, as a 0-d int64 tensor on the input's device (no host sync).
Runs past row C are dropped, distinct still counts them.

merge_reduce dispatches on where its inputs lie: CPU tensors run the
plain version, CUDA tensors launch the kernel (or raise).  On a GPU the
state's planes and counts are rows of one (W + 1, C) tensor.

The kernel is one launch with a decoupled look-back over tiles of TILE
rows, and a second small launch for the sentinel rows.  Its scratch (a
tile counter, then a status word, an aggregate and an inclusive prefix a
tile) stays allocated here, one for each device and stream, zeroed when
it is made and grown as a longer merge needs; each call passes a new
epoch that tags the status words it writes, so no reset runs between
calls.  When the epochs run out the scratch is zeroed on the stream and
the epochs start again at 1.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .compact import scratch_and_epoch
from .sort import SENTINEL

SOURCE = "kmer_tpu_torch/csrc/merge_reduce.cu"
REPLACES = None                # XLA's lax.cummin tail, no Pallas kernel
TILE = 2048                    # rows a block (csrc/merge_reduce.cu)
EPOCH_BITS = 32                # a status word's epoch (csrc/merge_reduce.cu)
MAX_PLANES = 240               # csrc/merge_reduce.cu MAX_PLANES
MAX_ROWS = (1 << 31) - 1       # a 32-bit run count
# calls of merge_reduce that launched the kernel (the plain version on
# CPU tensors does not count)
launches = 0
_lib = None
# (device index, stream handle) -> [scratch int64, last epoch]
_scratch: dict[tuple[int, int], list] = {}


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "merge_reduce.cu"),
                         "kmer_merge_reduce", cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.merge_reduce_launch.restype = i
        lib.merge_reduce_launch.argtypes = [vp, i, vp, i64, i64, vp,
                                            ctypes.c_uint32, vp, vp, vp]
        lib.merge_reduce_scratch_words.restype = i64
        lib.merge_reduce_scratch_words.argtypes = [i64]
        lib.merge_reduce_layout.restype = None
        lib.merge_reduce_layout.argtypes = [vp]
        layout = (ctypes.c_int32 * 2)()
        lib.merge_reduce_layout(ctypes.addressof(layout))
        if tuple(layout) != (TILE, EPOCH_BITS):
            raise RuntimeError(f"csrc/merge_reduce.cu has (TILE, EPOCH_BITS) "
                               f"= {tuple(layout)}, this wrapper "
                               f"{(TILE, EPOCH_BITS)}")
        _lib = lib
    return _lib


def _scratch_and_epoch(words: int, dev: torch.device, stream) -> tuple:
    """The scratch of (dev, stream), grown to `words`, and the epoch of
    this call."""
    return scratch_and_epoch(_scratch, words, dev, stream, EPOCH_BITS)


def merge_reduce_ref(words, counts: torch.Tensor, C: int):
    """Plain torch version: run totals by a cumsum and a backward cummin,
    the real run starts scattered to the front."""
    neq = words[0][1:] != words[0][:-1]
    for w in words[1:]:
        neq |= w[1:] != w[:-1]
    one = torch.ones(1, dtype=torch.bool, device=counts.device)
    starts = torch.cat([one, neq])
    ends = torch.cat([neq, one])
    # run totals without a scatter-add: csum at the run's end minus csum
    # just before its start.  csum does not decrease, so a row's own run
    # end carries the smallest csum of all ends at or after the row: a
    # backward cummin over (csum at ends, else INT64_MAX) spreads it
    csum = torch.cumsum(counts, 0)
    at_ends = torch.where(ends, csum, SENTINEL).flip(0)
    end_csum = torch.cummin(at_ends, 0).values.flip(0)
    totals = end_csum - (csum - counts)

    # compact the run starts of real keys to the front, in order, with
    # no host sync: live row i goes to row cumsum(live)[i] - 1, every
    # other row to the spare row C, which is cut off
    live = starts & (words[0] != SENTINEL)
    pos = torch.cumsum(live, 0)
    distinct = pos[-1].clone()
    dest = torch.where(live, pos - 1, C).clamp_(max=C)
    new_words = [torch.full((C + 1,), SENTINEL, dtype=torch.int64,
                            device=counts.device).scatter_(0, dest, w)[:C]
                 for w in words]
    new_counts = torch.zeros(C + 1, dtype=torch.int64,
                             device=counts.device).scatter_(0, dest,
                                                            totals)[:C]
    return new_words, new_counts, distinct


def merge_reduce(words, counts: torch.Tensor, C: int):
    """The merge's sorted rows -> (new_words, new_counts, distinct), C
    rows (module docstring)."""
    words = list(words)
    if counts.device.type == "cpu":
        return merge_reduce_ref(words, counts, C)
    if counts.device.type != "cuda":
        raise ValueError(f"no merge_reduce on {counts.device}")
    R, W = counts.numel(), len(words)
    if not 1 <= W <= MAX_PLANES:
        raise ValueError(f"merge_reduce takes 1 to {MAX_PLANES} key planes, "
                         f"got {W}")
    for t in (*words, counts):
        if (t.device != counts.device or t.dtype != torch.int64
                or t.shape != (R,) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"key planes and counts must be contiguous, "
                             f"16-byte aligned int64 tensors of shape ({R},) "
                             f"on {counts.device}")
    if not 0 <= C <= R or R > MAX_ROWS:
        raise ValueError(f"merge_reduce takes 0 <= C <= R <= {MAX_ROWS}, got "
                         f"C={C}, R={R}")
    dev = counts.device
    out = torch.empty((W + 1, C), dtype=torch.int64, device=dev)
    distinct = torch.zeros(1, dtype=torch.int64, device=dev)
    if R:
        lib = load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream()
            scratch, epoch = _scratch_and_epoch(
                lib.merge_reduce_scratch_words(R), dev, stream)
            ptrs = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
            rc = lib.merge_reduce_launch(
                ptrs, W, counts.data_ptr(), R, C, scratch.data_ptr(), epoch,
                out.data_ptr(), distinct.data_ptr(), stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"merge_reduce kernel launch failed: "
                               f"cudaError {rc}")
        global launches
        launches += 1
    return list(out[:W]), out[W], distinct[0]
