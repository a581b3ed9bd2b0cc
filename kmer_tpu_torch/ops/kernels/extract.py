"""Row-layout k-mer extraction with no collapse (the unfused count step's
front half), as one hand-written Hopper kernel (csrc/extract.cu) and its
plain torch version.

Counterpart of kmer_tpu/ops/pallas/extract.py `extract_repacked` (kernel
K7).  kmer_tpu's kernel returns each key as the (top, bot) uint32 words
of its sort layout and takes only 17 <= k <= 31 without ambiguous codes
(its unfused route extracts every other key outside a kernel); here a
key is W int64 words (ops/encode), so the kernel takes every k, spaced
seeds (`positions`, up to 63 selected bases), canonical or not, and the
ambiguity mask of skip-invalid mode.  Output: keys (B, P) int64, P = L -
span + 1, row-major, SENTINEL_KEY on invalid lanes (ops/extract
validity), or the tuple of words64(k) such planes for keys of more than
31 bases (the (hi, lo) pair up to 63); ops/encode.words_to_tpu_repacked
gives kmer_tpu's repacked words up to 63 bases.

Keys of more than 63 bases take the kernel's multi-word body, whose
plan `wide_plan` mirrors (the library's own plan is held against it when
it loads): a block's tile of consecutive outputs cut out of the rows it
stages in shared memory, or, for rows too wide to stage, one thread a
lane cut from device memory; launch_info says which.

extract_gapped_keys is the same kernel's gapped entry: the unfused
route's gapped L+R lanes (ops/extract.gapped_lanes, c-major), in the
planes of ops/encode.gapped_bases.

Both dispatch on where their inputs lie: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..encode import (HI_BASES, PAIR_BASES, gapped_bases, unpack_codes_i32,
                      words64)
from ..extract import (CUT_TABLE_WORDS, CUT_WORDS, MAX_ROLLED_SPAN,
                       check_window, gapped_lane_count, gapped_lanes,
                       seed_cut_table, window_keys)

SOURCE = "kmer_tpu_torch/csrc/extract.cu"
REPLACES = "kmer_tpu/ops/pallas/extract.py:88"
# calls of extract_keys that launched the kernel (the plain version on CPU
# tensors does not count): all of them, and those of the two-word
# (contiguous 32 <= k <= 63), spaced and multi-word (k > 63) variants;
# extract_gapped_keys' launches apart
launches = 0
wide_launches = 0
spaced_launches = 0
multi_launches = 0
gapped_launches = 0
_lib = None
# the cut bodies' threads a block, most outputs a thread and shared bytes
# a block (csrc/extract.cu)
CUT_THREADS, MAX_ITERS, CUT_SMEM = 256, 8, 48 * 1024
# (B, L, n, amb, thread slots) at which load() holds the kernel's plan
# against wide_plan: the main and `card` batches on an H100 (132 SMs of
# six resident blocks), P below a block, one window a row, rows too wide
# to stage
H100_THREAD_SLOTS = 132 * 6 * CUT_THREADS
PLAN_CHECKS = ((8192, 160, 101, False, H100_THREAD_SLOTS),
               (2048, 160, 101, True, H100_THREAD_SLOTS),
               (300, 200, 130, True, H100_THREAD_SLOTS),
               (300, 500, 500, True, H100_THREAD_SLOTS),
               (5, 64, 64, False, 1000))


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "extract.cu"),
                         "kmer_extract", cuda=True)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.extract_launch.restype = i
        lib.extract_launch.argtypes = [vp, i, i, vp, vp, vp, vp, i, i, i, i,
                                       i, i, vp, vp, vp]
        lib.extract_info.restype = i
        lib.extract_info.argtypes = [i, i, i, i, i, i, i, i, vp, vp, vp]
        lib.extract_wide_launch.restype = i
        lib.extract_wide_launch.argtypes = [vp, i, i, vp, vp, vp] + [i] * 6 + [
            vp]
        lib.extract_wide_info.restype = i
        lib.extract_wide_info.argtypes = [i] * 8 + [vp]
        lib.extract_wide_plan.restype = None
        lib.extract_wide_plan.argtypes = [i] * 6 + [ctypes.c_int64, vp]
        lib.extract_gapped_launch.restype = i
        lib.extract_gapped_launch.argtypes = [vp, i, i, vp, vp, vp] + [
            i] * 8 + [vp]
        lib.extract_gapped_info.restype = i
        lib.extract_gapped_info.argtypes = [i] * 10 + [vp]
        check_cut_layout(lib)
        for shape in PLAN_CHECKS:
            got = c_wide_plan(lib, *shape)
            if got != wide_plan(*shape):
                raise RuntimeError(f"extract.cu's multi-word plan {got} != "
                                   f"wide_plan{shape} {wide_plan(*shape)}")
        _lib = lib
    return _lib


def check_cut_layout(lib) -> None:
    """Raise unless a K1 or K7 library lays out the cut table as
    seed_cut_table does (its C entry cut_layout: CUT_WORDS,
    CUT_TABLE_WORDS, MAX_ROLLED_SPAN)."""
    got = (ctypes.c_int32 * 3)()
    lib.cut_layout(got)
    want = (CUT_WORDS, CUT_TABLE_WORDS, MAX_ROLLED_SPAN)
    if tuple(got) != want:
        raise RuntimeError(f"cut table layout {tuple(got)} of the kernel "
                           f"library != {want} of ops/extract")


def seed_args(positions, span: int):
    """A spaced seed's launch arguments for K1 and K7: its offsets and, for
    a span the window rolls (at most MAX_ROLLED_SPAN bases), its cut
    table; (None, None) for contiguous k-mers."""
    if positions is None:
        return None, None
    offs = (ctypes.c_int32 * len(positions))(*positions)
    cut = ((ctypes.c_uint32 * CUT_TABLE_WORDS)(*seed_cut_table(positions))
           if span <= MAX_ROLLED_SPAN else None)
    return offs, cut


class WidePlan(NamedTuple):
    """The multi-word body's plan (csrc/extract.cu `wide_plan`): the tile
    body (`tile`) with `iters` outputs a thread, each slot `cap` staged
    words at a pitch of `stride`, `smem` shared bytes a block; or, where
    even one output a thread outgrows CUT_SMEM, the row body."""
    tile: bool
    iters: int
    cap: int
    stride: int
    smem: int


def tile_cap(windows: int, n: int) -> int:
    """Words of a slot serving `windows` consecutive windows of n bases:
    those the windows span and the two a cut reads past them
    (kmer_window.cuh `tile_cap`)."""
    return ((windows + n + 13) >> 4) + 3


def wide_plan(B: int, L: int, n: int, amb: bool,
              thread_slots: int) -> WidePlan:
    """The plan extract_keys' multi-word launch takes for a (B, L) batch of
    keys of n > 63 bases (amb: u8 rows under the ambiguity mask) on a card
    of `thread_slots` resident threads of its kernel: iters the fewest
    outputs a thread that keep the grid within one wave (at most
    MAX_ITERS), fewer while a tile's t = CUT_THREADS x iters outputs
    touch rows (at most min(B, (t + P - 2) // P + 1) slots of cap words,
    and an int a slot) that outgrow CUT_SMEM."""
    P = L - n + 1
    iters = min(MAX_ITERS, max(1, -(-(B * P) // max(1, thread_slots))))
    while True:
        t = CUT_THREADS * iters
        slots = min(B, (t + P - 2) // P + 1)
        cap = tile_cap(min(P, t), n)
        stride = cap * (1 + bool(amb)) | 1
        smem = slots * (stride + 1) * 4
        if smem <= CUT_SMEM or iters == 1:
            return WidePlan(smem <= CUT_SMEM, iters, cap, stride, smem)
        iters -= 1


def c_wide_plan(lib, B: int, L: int, n: int, amb: bool, thread_slots: int,
                *, packed: bool = False, canonical: bool = False) -> WidePlan:
    """A K7 library's own multi-word plan (thread_slots 0: the current
    device's for the kernel of a `packed`, `canonical` launch)."""
    out = (ctypes.c_int64 * 5)()
    lib.extract_wide_plan(int(packed), B, L, n, int(canonical), int(amb),
                          thread_slots, out)
    return WidePlan(bool(out[0]), *out[1:])


# what the kernels' *_info entries report of a launch (kmer::report)
INFO_KEYS = ("threads", "blocks", "smem", "registers", "spill_bytes",
             "blocks_per_sm")


def report_info(entry, *args) -> dict:
    """Call a K1 or K7 library's *_info entry with the launch's arguments
    and return its report as a dict of INFO_KEYS."""
    info = (ctypes.c_int * (len(INFO_KEYS) + 1))()
    rc = entry(*args, info)
    if rc != 0:
        raise RuntimeError(f"kernel launch report failed: cudaError {rc}")
    return dict(zip(INFO_KEYS, info))


def launch_info(B: int, L: int, k: int, *, canonical: bool = False,
                mask_ambiguous: bool = False, packed: bool = True,
                positions=None) -> dict:
    """The launch extract_keys makes for a (B, L) batch on the current
    CUDA device, without making it: threads a block, blocks, dynamic
    shared bytes, registers a thread, spill bytes, resident blocks an SM;
    for keys of more than 63 bases also the body ("tile", or "row" for
    rows too wide to stage) and the outputs a thread."""
    span = check_window(k, positions, canonical)
    stride = (L + 15) // 16 if packed else L
    if positions is None and k > PAIR_BASES:
        plan = c_wide_plan(load(), B, L, k, mask_ambiguous and not packed, 0,
                           packed=packed, canonical=canonical)
        return {**report_info(load().extract_wide_info, int(packed), stride,
                              B, L, k, words64(k), int(canonical),
                              int(mask_ambiguous)),
                "body": "tile" if plan.tile else "row",
                "iters": plan.iters}
    offs, cut = seed_args(positions, span)
    return report_info(load().extract_info, int(packed),
                       (L + 15) // 16 if packed else L, B, L, k, span,
                       int(canonical), int(mask_ambiguous), offs, cut)


def _shape(codes: torch.Tensor, span: int, packed_width: int):
    """(B, L, P) of a batch; packed rows hold ceil(L/16) words."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D, got {tuple(codes.shape)}")
    B = codes.shape[0]
    L = packed_width or codes.shape[1]
    if packed_width and codes.shape[1] != (L + 15) // 16:
        raise ValueError(f"packed rows of width {L} hold {(L + 15) // 16} "
                         f"words, got {codes.shape[1]}")
    P = L - span + 1
    if P < 1:
        raise ValueError(f"row width {L} < window span {span}")
    return B, L, P


def gapped_launch_info(B: int, L: int, *, l_len: int, r_len: int,
                       c_min: int, c_max: int, mask_ambiguous: bool = False,
                       packed: bool = True) -> dict:
    """The launch extract_gapped_keys makes for a (B, L) batch, without
    making it (launch_info's keys)."""
    return report_info(load().extract_gapped_info, int(packed),
                       (L + 15) // 16 if packed else L, B, L, l_len, r_len,
                       c_min, gapped_lane_count(L, c_min, c_max),
                       len(gapped_bases(l_len, r_len)), int(mask_ambiguous))


def _check_batch(codes, lengths, limits, B: int, packed_width: int) -> None:
    want = torch.int32 if packed_width else torch.uint8
    if codes.dtype != want or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D {want} tensor, "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    for name, t in (("lengths", lengths), ("limits", limits)):
        if (t.device != codes.device or t.dtype != torch.int32
                or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {codes.device}")


def extract_keys_ref(codes: torch.Tensor, lengths: torch.Tensor,
                     limits: torch.Tensor, k: int, *, canonical: bool = False,
                     mask_ambiguous: bool = False, packed_width: int = 0,
                     positions=None):
    """Plain torch version: ops/extract.window_keys (kmer_lanes,
    canonical_kmer_lanes and spaced_lanes in one)."""
    span = check_window(k, positions, canonical)
    _shape(codes, span, packed_width)
    if packed_width:
        codes = unpack_codes_i32(codes, packed_width)
    keys, _ = window_keys(codes, lengths, positions or range(k),
                          limits=limits, mask_ambiguous=mask_ambiguous,
                          canonical=canonical)
    return keys


def extract_keys(codes: torch.Tensor, lengths: torch.Tensor,
                 limits: torch.Tensor, k: int, *, canonical: bool = False,
                 mask_ambiguous: bool = False, packed_width: int = 0,
                 positions=None):
    """One batch -> keys (B, P) int64, SENTINEL_KEY on invalid lanes, or
    the tuple of words64(k) of them for keys of more than 31 bases (the
    (hi, lo) pair up to 63).

    codes: (B, L) uint8 codes (code 4 = ambiguous base), or with
    packed_width = L the (B, ceil(L/16)) int32 view of the 2-bit packed
    rows.  lengths, limits: (B,) int32.  positions: a spaced seed's k
    window offsets, or None for contiguous k-mers.
    """
    if codes.device.type == "cpu":
        return extract_keys_ref(codes, lengths, limits, k,
                                canonical=canonical,
                                mask_ambiguous=mask_ambiguous,
                                packed_width=packed_width,
                                positions=positions)
    if codes.device.type != "cuda":
        raise ValueError(f"no extract_keys on {codes.device}")
    span = check_window(k, positions, canonical)
    B, L, P = _shape(codes, span, packed_width)
    _check_batch(codes, lengths, limits, B, packed_width)
    if positions is None and k > PAIR_BASES:
        return _extract_multi(codes, lengths, limits, k, canonical,
                              mask_ambiguous, packed_width, B, L, P)
    keys = torch.empty((B, P), dtype=torch.int64, device=codes.device)
    lo = (torch.empty((B, P), dtype=torch.int64, device=codes.device)
          if k > HI_BASES else None)
    out = (keys, lo) if lo is not None else keys
    if B == 0:
        return out
    lib = load()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        offs, cut = seed_args(positions, span)
        rc = lib.extract_launch(
            codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
            lengths.data_ptr(), limits.data_ptr(), keys.data_ptr(),
            None if lo is None else lo.data_ptr(), B, L, k, span,
            int(canonical), int(mask_ambiguous), offs, cut, stream)
    if rc != 0:
        raise RuntimeError(f"extract kernel launch failed: cudaError {rc}")
    global launches, wide_launches, spaced_launches
    launches += 1
    if positions is not None:
        spaced_launches += 1
    elif lo is not None:
        wide_launches += 1
    return out


def _extract_multi(codes, lengths, limits, k: int, canonical: bool,
                   mask_ambiguous: bool, packed_width: int, B: int, L: int,
                   P: int):
    """extract_keys' launch for a contiguous key of more than 63 bases:
    the words64(k) planes of one (W, B, P) buffer."""
    W = words64(k)
    out = torch.empty((W, B, P), dtype=torch.int64, device=codes.device)
    if B:
        lib = load()
        with torch.cuda.device(codes.device):
            rc = lib.extract_wide_launch(
                codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
                lengths.data_ptr(), limits.data_ptr(), out.data_ptr(), B, L,
                k, W, int(canonical), int(mask_ambiguous),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"extract kernel launch failed: cudaError "
                               f"{rc}")
        global launches, multi_launches
        launches += 1
        multi_launches += 1
    return tuple(out)


def _gapped_shape(codes, l_len: int, r_len: int, c_min: int, c_max: int,
                  packed_width: int):
    """(B, L, T) of a gapped batch."""
    if not (l_len >= 1 and r_len >= 1 and c_min >= l_len + r_len):
        raise ValueError("gapped keys need l_len, r_len >= 1 and c_min >= "
                         "l_len + r_len (non-overlapping windows)")
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D, got {tuple(codes.shape)}")
    B = codes.shape[0]
    L = packed_width or codes.shape[1]
    if packed_width and codes.shape[1] != (L + 15) // 16:
        raise ValueError(f"packed rows of width {L} hold {(L + 15) // 16} "
                         f"words, got {codes.shape[1]}")
    return B, L, gapped_lane_count(L, c_min, c_max)


def extract_gapped_keys_ref(codes: torch.Tensor, lengths: torch.Tensor,
                            limits: torch.Tensor, *, l_len: int, r_len: int,
                            c_min: int, c_max: int,
                            mask_ambiguous: bool = False,
                            packed_width: int = 0) -> tuple:
    """Plain torch version: ops/extract.gapped_lanes."""
    _, L, _ = _gapped_shape(codes, l_len, r_len, c_min, c_max, packed_width)
    if packed_width:
        codes = unpack_codes_i32(codes, L)
    planes, _ = gapped_lanes(codes, lengths, l_len, r_len, c_min, c_max,
                             limits=limits, mask_ambiguous=mask_ambiguous)
    return planes


def extract_gapped_keys(codes: torch.Tensor, lengths: torch.Tensor,
                        limits: torch.Tensor, *, l_len: int, r_len: int,
                        c_min: int, c_max: int, mask_ambiguous: bool = False,
                        packed_width: int = 0) -> tuple:
    """One batch -> the gapped L+R lanes of the unfused route: the planes
    of ops/encode.gapped_bases(l_len, r_len), each (B, T) int64, T =
    ops/extract.gapped_lane_count(L, c_min, c_max), c-major, SENTINEL_KEY
    on invalid lanes (ops/extract.gapped_lanes' contract).  codes,
    lengths, limits as extract_keys'."""
    if codes.device.type == "cpu":
        return extract_gapped_keys_ref(
            codes, lengths, limits, l_len=l_len, r_len=r_len, c_min=c_min,
            c_max=c_max, mask_ambiguous=mask_ambiguous,
            packed_width=packed_width)
    if codes.device.type != "cuda":
        raise ValueError(f"no extract_gapped_keys on {codes.device}")
    B, L, T = _gapped_shape(codes, l_len, r_len, c_min, c_max, packed_width)
    _check_batch(codes, lengths, limits, B, packed_width)
    W = len(gapped_bases(l_len, r_len))
    out = torch.empty((W, B, T), dtype=torch.int64, device=codes.device)
    if B and T:
        lib = load()
        with torch.cuda.device(codes.device):
            rc = lib.extract_gapped_launch(
                codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
                lengths.data_ptr(), limits.data_ptr(), out.data_ptr(), B, L,
                l_len, r_len, c_min, T, W, int(mask_ambiguous),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"extract kernel launch failed: cudaError "
                               f"{rc}")
        global gapped_launches
        gapped_launches += 1
    return tuple(out)
