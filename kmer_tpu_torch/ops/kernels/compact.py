"""On-device compaction: the live lanes (count > 0) of one count step's
output as contiguous host-ready records, as one hand-written Hopper
kernel (csrc/compact.cu) and its plain torch version.

Counterpart of kmer_tpu/ops/pallas/compact.py `pack_groups` and of the
back half of kmer_tpu/ops/count.py `compact_from_runs`.  kmer_tpu packs
repacked uint32 key words and the count into 128-lane rows (its TPU
tiling unit), and sorts each group's live records to its front first so
that one in-order DMA per group can pack them.  Here a record is what
the host aggregation (pipeline/table.reduce_fused) takes as it stands:

- from K1's (keys, int8 counts) or the unfused step's (keys, int32
  counts) (ops/count.grouped_count): the int64 key, read as uint64;
- from K3's (hi, lo, counts), and from K1's or the unfused step's pairs
  of keys of 32 to 63 bases: the key value hi * 4**r_len + lo, one
  uint64 when the key has at most 31 bases, else the two uint64 halves
  [vhi, vlo] (ops/encode.pairs_to_value; at r_len = 32 the halves are hi
  and lo with its flipped top bit put back);
- from three or four key planes (64 to 125 bases, or a gapped key past
  31-base windows; compact mode caps keys at 111 bases): the words as
  they are, which the host fuses (records_fused);

and the count, widened to int64.  Output contract: keys (n,), (n, 2) or
(n, W) int64, counts (n,) int64 and total (1,) int64 on the input's
device,
n = the number of lanes; rows [0, total) hold every live lane's record
in lane order, rows past total are unspecified.  The host reads back
rows [0, total) only, so the copy scales with the live lanes.

compact dispatches on where its inputs lie: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise).  A stream with no
lanes launches nothing.

The kernel is one launch with a decoupled look-back over tiles of TILE
lanes.  Its scratch (a tile counter, then one status word a tile) stays
allocated here, one for each device and stream, zeroed when it is made
and grown as a longer stream needs; each call passes a new epoch that
tags the status words it writes, so no reset runs between calls.  When
the epochs run out the scratch is zeroed on the stream and the epochs
start again at 1.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..encode import LO_FLIP, words_per_key

SOURCE = "kmer_tpu_torch/csrc/compact.cu"
REPLACES = "kmer_tpu/ops/pallas/compact.py:96"
TILE = 2048                    # lanes per block (csrc/compact.cu)
EPOCH_BITS = 22                # a status word's epoch field (csrc/compact.cu)
# calls of compact that launched the kernel (the plain version on CPU
# tensors does not count)
launches = 0
_lib = None
# (device index, stream handle) -> [scratch (1 + tiles) int64, last epoch]
_scratch: dict[tuple[int, int], list] = {}


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "compact.cu"),
                         "kmer_compact", cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.compact_launch.restype = i
        lib.compact_launch.argtypes = [vp, i, vp, i, i64, vp, ctypes.c_uint32,
                                       i, i, vp, vp, vp, vp]
        lib.compact_layout.restype = None
        lib.compact_layout.argtypes = [vp]
        layout = (ctypes.c_int32 * 2)()
        lib.compact_layout(ctypes.addressof(layout))
        if tuple(layout) != (TILE, EPOCH_BITS):
            raise RuntimeError(f"csrc/compact.cu has (TILE, EPOCH_BITS) = "
                               f"{tuple(layout)}, this wrapper "
                               f"{(TILE, EPOCH_BITS)}")
        _lib = lib
    return _lib


def scratch_and_epoch(cache: dict, words: int, dev: torch.device, stream,
                      epoch_bits: int) -> tuple:
    """The look-back scratch of (dev, stream) in `cache` (a kernel's own
    dict), grown to `words` int64 words (zeroed), and this call's epoch in
    [1, 2**epoch_bits); the scratch is zeroed again when the epochs run
    out.  Shared by K4 and merge_reduce."""
    key = (dev.index, stream.cuda_stream)
    entry = cache.get(key)
    if entry is None or entry[0].numel() < words:
        entry = [torch.zeros(max(words, 1024), dtype=torch.int64,
                             device=dev), 0]
        cache[key] = entry
    entry[1] += 1
    if entry[1] == 1 << epoch_bits:
        entry[0].zero_()
        entry[1] = 1
    return entry[0], entry[1]


def _scratch_and_epoch(n: int, dev: torch.device, stream) -> tuple:
    """K4's scratch, grown to hold n lanes' tiles, and this call's epoch."""
    return scratch_and_epoch(_scratch, 1 + -(-n // TILE), dev, stream,
                             EPOCH_BITS)


MAX_PLANES = 4                 # csrc/compact.cu MAX_PLANES


def _mode(planes, r_len: int, n_bases: int) -> int:
    """0: one key plane; 1: a gapped pair to one uint64 (n_bases <= 31);
    2: a gapped pair to two uint64 halves; 3: three or four planes as they
    are."""
    if len(planes) == 1:
        return 0
    if 3 <= len(planes) <= MAX_PLANES:
        return 3
    if len(planes) != 2 or not 1 <= r_len <= 32:
        raise ValueError(f"compact takes 1 to {MAX_PLANES} key planes, a "
                         f"pair with 1 <= r_len <= 32; got {len(planes)} "
                         f"planes, r_len={r_len}")
    return 1 if words_per_key(n_bases) <= 2 else 2


def _record_shape(mode: int, n: int, W: int) -> tuple:
    return (n,) if mode <= 1 else (n, 2) if mode == 2 else (n, W)


def compact_ref(planes, counts: torch.Tensor, *, r_len: int = 0,
                n_bases: int = 0):
    """Plain torch version: a boolean mask over the flat lanes, then the
    pair -> value shifts on int64 (hi is below 2**62 on live lanes, so
    the arithmetic shift is the logical one; r_len = 32 takes lo's flip
    off instead)."""
    mode = _mode(planes, r_len, n_bases)
    n = counts.numel()
    live = counts.reshape(-1) > 0
    total = int(live.sum())
    key0 = planes[0].reshape(-1)[live]
    keys = torch.zeros(_record_shape(mode, n, len(planes)),
                       dtype=torch.int64, device=counts.device)
    if mode == 0:
        keys[:total] = key0
    elif mode == 3:
        for q, p in enumerate(planes):
            keys[:total, q] = p.reshape(-1)[live]
    elif r_len == 32:
        keys[:total, 0] = key0
        keys[:total, 1] = planes[1].reshape(-1)[live] ^ LO_FLIP
    else:
        s = 2 * r_len
        vlo = (key0 << s) | planes[1].reshape(-1)[live]
        if mode == 1:
            keys[:total] = vlo
        else:
            keys[:total, 0] = key0 >> (64 - s)
            keys[:total, 1] = vlo
    out_counts = torch.zeros(n, dtype=torch.int64, device=counts.device)
    out_counts[:total] = counts.reshape(-1)[live]
    return keys, out_counts, torch.tensor([total], dtype=torch.int64,
                                          device=counts.device)


def compact(planes, counts: torch.Tensor, *, r_len: int = 0,
            n_bases: int = 0):
    """(keys,), (hi, lo) or three or four int64 planes + counts of the
    same shape (int8 from the fused steps, int32 from
    ops/count.grouped_count) -> (keys (n,), (n, 2) or (n, W) int64,
    counts (n,) int64, total (1,) int64); r_len and n_bases describe a
    pair."""
    planes = tuple(planes)
    if counts.device.type == "cpu":
        return compact_ref(planes, counts, r_len=r_len, n_bases=n_bases)
    if counts.device.type != "cuda":
        raise ValueError(f"no compact on {counts.device}")
    mode = _mode(planes, r_len, n_bases)
    for p in planes:
        if (p.device != counts.device or p.dtype != torch.int64
                or p.shape != counts.shape or not p.is_contiguous()):
            raise ValueError(f"key planes must be contiguous int64 tensors "
                             f"of shape {tuple(counts.shape)} on "
                             f"{counts.device}")
    if (counts.dtype not in (torch.int8, torch.int32)
            or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int8 or int32 tensor")
    n = counts.numel()
    dev = counts.device
    keys = torch.empty(_record_shape(mode, n, len(planes)),
                       dtype=torch.int64, device=dev)
    out_counts = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return keys, out_counts, torch.zeros(1, dtype=torch.int64,
                                             device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)  # the last tile's
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        scratch, epoch = _scratch_and_epoch(n, dev, stream)
        ptrs = (ctypes.c_void_p * len(planes))(*[p.data_ptr()
                                                 for p in planes])
        rc = lib.compact_launch(
            ptrs, len(planes), counts.data_ptr(), counts.element_size(), n,
            scratch.data_ptr(), epoch, mode, 2 * r_len, keys.data_ptr(),
            out_counts.data_ptr(), total.data_ptr(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"compact kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return keys, out_counts, total


def records_fused(keys: np.ndarray, bases) -> np.ndarray:
    """Host records of compact (rows [0, total)) -> fused keys
    (pipeline/table.reduce_fused): records of one or two planes are fused
    already (read as uint64); three or four planes (bases: each plane's
    bases) are fused here."""
    keys = np.asarray(keys)
    if len(bases) <= 2:
        return keys.view(np.uint64)
    from ...pipeline.table import planes_to_fused
    return planes_to_fused([keys[:, q] for q in range(len(bases))], bases)


def record_width(n_fields: int) -> int:
    """kmer_tpu's record width in uint32 fields (compact.py:27): the
    power of two >= n_fields, at least 4."""
    return max(4, 1 << (n_fields - 1).bit_length())


def records_from_tpu_rows(row_blocks: np.ndarray, n_bases: int):
    """kmer_tpu's compacted row blocks ((R, 128) uint32 rows of repacked
    key words + count + zero padding, as KmerTable.from_compact reads
    them) -> this port's records (fused uint64 keys, int64 counts) of
    the live rows, in row order."""
    from ...pipeline.table import fuse_words
    W = words_per_key(n_bases)
    rows = np.asarray(row_blocks, np.uint32).reshape(-1, record_width(W + 1))
    rows = rows[rows[:, W] > 0]
    rw = [rows[:, j] for j in range(W)]
    s = 2 * n_bases - 32 * (W - 1)
    if W == 1:
        std = rw
    elif s == 0:
        std = [rw[-1]] + rw[:-1]          # the last word is a 0 flag
    else:
        # 32 key bits in words 0..W-2, the s residual bits in the last
        t, s = np.uint32(32 - s), np.uint32(s)
        std = [rw[0] >> t]
        std += [(rw[j - 1] << s) | (rw[j] >> t) for j in range(1, W - 1)]
        std.append((rw[W - 2] << s) | rw[W - 1])
    keys = np.stack(std, axis=1) if rows.size else np.zeros((0, W),
                                                            np.uint32)
    return fuse_words(keys, n_bases), rows[:, W].astype(np.int64)
