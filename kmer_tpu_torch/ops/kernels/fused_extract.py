"""The fused count step: extraction -> canonical -> validity ->
in-segment collapse, as one hand-written Hopper kernel
(csrc/fused_extract.cu) and its plain torch version.

Counterpart of kmer_tpu/ops/pallas/fused_extract.py
`fused_extract_count_T`, for every key it takes: contiguous k-mers of 1
to 63 bases and spaced seeds (`positions`, the offsets of a mask's '1's,
at most 63 of them).  Output contract (the same partial-aggregation
contract): keys (P_pad, B) int64, position-major, SENTINEL_KEY on invalid
lanes -- for keys of 32 to 63 bases the (hi, lo) pair of two such planes
(ops/encode) -- and counts (P_pad, B) int8; positions are cut into
seg-sized segments and each key's in-segment count sits on its first
occurrence (ops/kernels/fused_count).  Equal keys may recur across
segments and rows; the host aggregation merges them.

fused_extract_count dispatches on where its inputs lie: CPU tensors run
the plain version, CUDA tensors launch the kernel (or raise).  The
kernel builds from the checkout's source at first use.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...utils import stagetime
from ..encode import HI_BASES, SENTINEL_KEY, unpack_codes_i32
from ..extract import check_window, window_keys
from .extract import check_cut_layout, report_info, seed_args
from .fused_count import dedup_runlen

SOURCE = "kmer_tpu_torch/csrc/fused_extract.cu"
REPLACES = "kmer_tpu/ops/pallas/fused_extract.py:789"
# kernel launches made by fused_extract_count (the plain version on CPU
# tensors does not count): all of them, and those of the two-word
# (contiguous 32 <= k <= 63) and spaced variants
launches = 0
wide_launches = 0
spaced_launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "fused_extract.cu"),
                         "kmer_fused_extract", cuda=True)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_extract_count_launch.restype = i
        lib.fused_extract_count_launch.argtypes = [
            vp, i, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp, vp,
            vp]
        lib.fused_extract_count_info.restype = i
        lib.fused_extract_count_info.argtypes = [i, i, i, i, i, i, i, i, i,
                                                 i, i, vp, vp, vp]
        check_cut_layout(lib)
        _lib = lib
    return _lib


def _shape(codes: torch.Tensor, span: int, seg: int, packed_width: int):
    """(B, L, P, P_pad) of a batch; packed rows hold ceil(L/16) words."""
    if seg not in (2, 4, 8, 16):
        raise ValueError(f"seg must be 2, 4, 8 or 16, got {seg}")
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
    return B, L, P, -(-P // seg) * seg


def launch_info(B: int, L: int, k: int, *, canonical: bool = False,
                mask_ambiguous: bool = False, seg: int = 2,
                packed: bool = True, positions=None) -> dict:
    """The launch fused_extract_count makes for a (B, L) batch on the
    current CUDA device, without making it (ops/kernels/extract.INFO_KEYS:
    threads a block, blocks, shared bytes, registers, spills, resident
    blocks an SM)."""
    span = check_window(k, positions, canonical)
    P = L - span + 1
    offs, cut = seed_args(positions, span)
    return report_info(load().fused_extract_count_info, int(packed),
                       (L + 15) // 16 if packed else L, B, L, k, span, P,
                       -(-P // seg) * seg, int(canonical),
                       int(mask_ambiguous), seg, offs, cut)


def fused_extract_count_ref(codes: torch.Tensor, lengths: torch.Tensor,
                            limits: torch.Tensor, k: int, *,
                            canonical: bool = False,
                            mask_ambiguous: bool = False, seg: int = 2,
                            packed_width: int = 0, positions=None):
    """Plain torch version: extraction (+ canonical) and the collapse,
    composed from ops/extract.window_keys (kmer_lanes, canonical_kmer_lanes
    and spaced_lanes in one) and ops/kernels/fused_count."""
    span = check_window(k, positions, canonical)
    B, L, P, P_pad = _shape(codes, span, seg, packed_width)
    if packed_width:
        codes = unpack_codes_i32(codes, L)
    keys, _ = window_keys(codes, lengths, positions or range(k),
                          limits=limits, mask_ambiguous=mask_ambiguous,
                          canonical=canonical)
    planes = keys if isinstance(keys, tuple) else (keys,)
    out = []
    for w in planes:
        o = torch.full((P_pad, B), SENTINEL_KEY, dtype=torch.int64,
                       device=codes.device)
        o[:P] = w.T
        out.append(o)
    counts = dedup_runlen(out[0], seg, lo=out[1] if len(out) == 2 else None)
    return (tuple(out) if len(out) == 2 else out[0]), counts


def fused_extract_count(codes: torch.Tensor, lengths: torch.Tensor,
                        limits: torch.Tensor, k: int, *,
                        canonical: bool = False, mask_ambiguous: bool = False,
                        seg: int = 2, packed_width: int = 0, positions=None):
    """One batch -> (keys, counts (P_pad, B) int8): keys (P_pad, B) int64
    for keys of at most 31 bases, else the (hi, lo) pair of them.

    codes: (B, L) uint8 codes (code 4 = ambiguous base), or with
    packed_width = L the (B, ceil(L/16)) int32 view of the 2-bit packed
    rows.  lengths, limits: (B,) int32.  seg: power of two <= 16.
    positions: a spaced seed's k window offsets (ascending from 0; span
    positions[-1] + 1), or None for contiguous k-mers.  Inside an `op::K1`
    range while a profiler records (utils/stagetime.span).
    """
    with stagetime.span("op::K1"):
        return _fused_extract_count(
            codes, lengths, limits, k, canonical=canonical,
            mask_ambiguous=mask_ambiguous, seg=seg,
            packed_width=packed_width, positions=positions)


def _fused_extract_count(codes, lengths, limits, k, *, canonical,
                         mask_ambiguous, seg, packed_width, positions):
    if codes.device.type == "cpu":
        return fused_extract_count_ref(
            codes, lengths, limits, k, canonical=canonical,
            mask_ambiguous=mask_ambiguous, seg=seg,
            packed_width=packed_width, positions=positions)
    if codes.device.type != "cuda":
        raise ValueError(f"no fused_extract_count on {codes.device}")
    span = check_window(k, positions, canonical)
    B, L, P, P_pad = _shape(codes, span, seg, packed_width)
    want = torch.int32 if packed_width else torch.uint8
    if codes.dtype != want or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D {want} tensor, "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    for name, t in (("lengths", lengths), ("limits", limits)):
        if (t.device != codes.device or t.dtype != torch.int32
                or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {codes.device}")
    lib = load()
    dev = codes.device
    keys = torch.empty((P_pad, B), dtype=torch.int64, device=dev)
    lo = (torch.empty((P_pad, B), dtype=torch.int64, device=dev)
          if k > HI_BASES else None)
    counts = torch.empty((P_pad, B), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        offs, cut = seed_args(positions, span)
        rc = lib.fused_extract_count_launch(
            codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
            lengths.data_ptr(), limits.data_ptr(), keys.data_ptr(),
            None if lo is None else lo.data_ptr(), counts.data_ptr(), B, L, k,
            span, P, P_pad, int(canonical), int(mask_ambiguous), seg, offs,
            cut, stream)
    if rc != 0:
        raise RuntimeError(f"fused_extract_count kernel launch failed: "
                           f"cudaError {rc}")
    global launches, wide_launches, spaced_launches
    launches += 1
    if positions is not None:
        spaced_launches += 1
    elif lo is not None:
        wide_launches += 1
    return ((keys, lo) if lo is not None else keys), counts
