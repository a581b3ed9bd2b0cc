"""The fused gapped count step: the gapped L+R chunk keys of every chunk
size -> validity -> in-segment collapse, as one hand-written Hopper
kernel (csrc/fused_gapped.cu) and its plain torch version.

Counterpart of kmer_tpu/ops/pallas/fused_gapped.py
`fused_gapped_count_T`.  Output contract (the partial-aggregation
contract): hi, lo (B, T_pad) int64 and counts (B, T_pad) int8, read-major.
Row b holds the c-major lane stream of read b (ops/extract.gapped_lanes:
T lanes, padded with sentinel lanes to T_pad = ceil(T/seg)*seg); each
lane is the key pair (hi, lo) of ops/encode, SENTINEL_KEY in both on
invalid and padding lanes.  Lanes are cut into seg-sized segments and
each key's in-segment count sits on its first occurrence
(ops/kernels/fused_count); equal keys may recur across segments and
rows, and the host aggregation merges them.

fused_gapped_count dispatches on where its inputs lie: CPU tensors run
the plain version, CUDA tensors launch the kernel (or raise).  The
kernel builds from the checkout's source at first use.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..encode import HI_BASES, SENTINEL_KEY, unpack_codes_i32
from ..extract import gapped_lane_count, gapped_lanes
from .fused_count import dedup_runlen

SOURCE = "kmer_tpu_torch/csrc/fused_gapped.cu"
REPLACES = "kmer_tpu/ops/pallas/fused_gapped.py:360"
# widest row the wrapper takes (the count driver splits longer reads, so
# it sets the batches' row width); the kernel cuts its windows from the
# packed rows in device memory, or from u8 rows a warp packs into shared
# memory (read in place where they would not fit), so no shared-memory
# table bounds the row
MAX_ROW = 12288
# kernel launches made by fused_gapped_count (the plain version on CPU
# tensors does not count)
launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "fused_gapped.cu"),
                         "kmer_fused_gapped", cuda=True)
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.fused_gapped_count_launch.restype = i
        lib.fused_gapped_count_launch.argtypes = [
            vp, i, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i64, i64, i, i,
            vp]
        lib.fused_gapped_info.restype = i
        lib.fused_gapped_info.argtypes = [i, i, i, i, i, i, i, i64, i64, i,
                                          i, vp]
        _lib = lib
    return _lib


def launch_info(B: int, L: int, *, l_len: int, r_len: int, c_min: int,
                c_max: int, seg: int = 2, mask_ambiguous: bool = False,
                packed: bool = True) -> dict:
    """The launch fused_gapped_count makes for a (B, L) batch on the
    current CUDA device, without making it: threads a block, blocks,
    dynamic shared bytes, registers a thread, spill bytes, resident blocks
    an SM."""
    from .extract import report_info
    T = gapped_lane_count(L, c_min, c_max)
    T_pad = -(-T // seg) * seg
    return report_info(load().fused_gapped_info, int(packed), B, L, l_len,
                       r_len, c_min, c_max, T, T_pad, int(mask_ambiguous),
                       seg)


def _shape(codes: torch.Tensor, l_len: int, r_len: int, c_min: int,
           c_max: int, seg: int, packed_width: int):
    """(B, L, T, T_pad) of a batch; packed rows hold ceil(L/16) words.
    Each window is one int64 sub-key (l_len, r_len <= 31)."""
    if not (1 <= l_len <= HI_BASES and 1 <= r_len <= HI_BASES):
        raise ValueError(
            f"l_len={l_len}, r_len={r_len}: K3 takes gapped windows of 1 to "
            f"{HI_BASES} bases (one int64 each); longer ones take the "
            "unfused route (pipeline/count.gapped_step_sort: K7's gapped "
            "lanes, then the grouped counts)")
    if c_min < l_len + r_len:
        raise ValueError("gapped mode needs c_min >= l_len + r_len "
                         "(non-overlapping L/R windows)")
    if seg not in (2, 4, 8, 16):
        raise ValueError(f"seg must be 2, 4, 8 or 16, got {seg}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D, got {tuple(codes.shape)}")
    B = codes.shape[0]
    L = packed_width or codes.shape[1]
    if packed_width and codes.shape[1] != (L + 15) // 16:
        raise ValueError(f"packed rows of width {L} hold {(L + 15) // 16} "
                         f"words, got {codes.shape[1]}")
    if L > MAX_ROW:
        raise ValueError(f"row width {L} > {MAX_ROW}, the widest row the "
                         "gapped kernel takes")
    T = gapped_lane_count(L, c_min, c_max)
    return B, L, T, -(-T // seg) * seg


def fused_gapped_count_ref(codes: torch.Tensor, lengths: torch.Tensor,
                           limits: torch.Tensor, *, l_len: int, r_len: int,
                           c_min: int, c_max: int,
                           mask_ambiguous: bool = False, seg: int = 2,
                           packed_width: int = 0):
    """Plain torch version: gapped_lanes -> pad to T_pad -> the collapse
    (ops/extract, ops/kernels/fused_count)."""
    B, L, T, T_pad = _shape(codes, l_len, r_len, c_min, c_max, seg,
                            packed_width)
    if packed_width:
        codes = unpack_codes_i32(codes, L)
    (hi, lo), _ = gapped_lanes(codes, lengths, l_len, r_len, c_min, c_max,
                               limits=limits, mask_ambiguous=mask_ambiguous)
    pad = torch.full((B, T_pad - T), SENTINEL_KEY, dtype=torch.int64,
                     device=codes.device)
    hi, lo = torch.cat([hi, pad], dim=1), torch.cat([lo, pad], dim=1)
    counts = dedup_runlen(hi.T, seg, lo.T).T.contiguous()
    return hi, lo, counts


def fused_gapped_count(codes: torch.Tensor, lengths: torch.Tensor,
                       limits: torch.Tensor, *, l_len: int, r_len: int,
                       c_min: int, c_max: int, mask_ambiguous: bool = False,
                       seg: int = 2, packed_width: int = 0):
    """One batch -> (hi, lo (B, T_pad) int64, counts (B, T_pad) int8).

    codes: (B, L) uint8 codes (code 4 = ambiguous base), or with
    packed_width = L the (B, ceil(L/16)) int32 view of the 2-bit packed
    rows.  lengths, limits: (B,) int32.  seg: power of two <= 16.  A row
    narrower than c_min has no lanes (T_pad = 0) and launches nothing.
    """
    if codes.device.type == "cpu":
        return fused_gapped_count_ref(
            codes, lengths, limits, l_len=l_len, r_len=r_len, c_min=c_min,
            c_max=c_max, mask_ambiguous=mask_ambiguous, seg=seg,
            packed_width=packed_width)
    if codes.device.type != "cuda":
        raise ValueError(f"no fused_gapped_count on {codes.device}")
    B, L, T, T_pad = _shape(codes, l_len, r_len, c_min, c_max, seg,
                            packed_width)
    want = torch.int32 if packed_width else torch.uint8
    if codes.dtype != want or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D {want} tensor, "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    for name, t in (("lengths", lengths), ("limits", limits)):
        if (t.device != codes.device or t.dtype != torch.int32
                or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {codes.device}")
    hi = torch.empty((B, T_pad), dtype=torch.int64, device=codes.device)
    lo = torch.empty((B, T_pad), dtype=torch.int64, device=codes.device)
    counts = torch.empty((B, T_pad), dtype=torch.int8, device=codes.device)
    if T == 0 or B == 0:
        return hi, lo, counts
    lib = load()
    with torch.cuda.device(codes.device):
        rc = lib.fused_gapped_count_launch(
            codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
            lengths.data_ptr(), limits.data_ptr(), hi.data_ptr(),
            lo.data_ptr(), counts.data_ptr(), B, L, l_len, r_len, c_min,
            c_max, T, T_pad, int(mask_ambiguous), seg,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_gapped_count kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return hi, lo, counts
