"""The fused count step: extraction -> canonical -> validity ->
in-segment collapse, as one hand-written Hopper kernel
(csrc/fused_extract.cu) and its plain torch version.

Counterpart of kmer_tpu/ops/pallas/fused_extract.py
`fused_extract_count_T`.  Output contract (the same partial-aggregation
contract): keys (P_pad, B) int64, position-major, SENTINEL_KEY on
invalid lanes, and counts (P_pad, B) int8; positions are cut into
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

from ..canonical import canonical_kmer_lanes
from ..encode import SENTINEL_KEY, check_k, unpack_codes_i32
from ..extract import kmer_lanes
from .fused_count import dedup_runlen

SOURCE = "kmer_tpu_torch/csrc/fused_extract.cu"
REPLACES = "kmer_tpu/ops/pallas/fused_extract.py:789"
# kernel launches made by fused_extract_count (the plain version on CPU
# tensors does not count)
launches = 0
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
            vp, i, i, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
        _lib = lib
    return _lib


def _shape(codes: torch.Tensor, k: int, seg: int, packed_width: int):
    """(B, L, P, P_pad) of a batch; packed rows hold ceil(L/16) words."""
    check_k(k)
    if seg not in (2, 4, 8, 16):
        raise ValueError(f"seg must be 2, 4, 8 or 16, got {seg}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D, got {tuple(codes.shape)}")
    B = codes.shape[0]
    L = packed_width or codes.shape[1]
    if packed_width and codes.shape[1] != (L + 15) // 16:
        raise ValueError(f"packed rows of width {L} hold {(L + 15) // 16} "
                         f"words, got {codes.shape[1]}")
    P = L - k + 1
    if P < 1:
        raise ValueError(f"row width {L} < k={k}")
    return B, L, P, -(-P // seg) * seg


def fused_extract_count_ref(codes: torch.Tensor, lengths: torch.Tensor,
                            limits: torch.Tensor, k: int, *,
                            canonical: bool = False,
                            mask_ambiguous: bool = False, seg: int = 2,
                            packed_width: int = 0):
    """Plain torch version: extraction (+ canonical) and the collapse,
    composed from ops/extract, ops/canonical and ops/kernels/fused_count."""
    B, L, P, P_pad = _shape(codes, k, seg, packed_width)
    if packed_width:
        codes = unpack_codes_i32(codes, L)
    fn = canonical_kmer_lanes if canonical else kmer_lanes
    keys, _ = fn(codes, lengths, k, limits=limits,
                 mask_ambiguous=mask_ambiguous)
    out = torch.full((P_pad, B), SENTINEL_KEY, dtype=torch.int64,
                     device=codes.device)
    out[:P] = keys.T
    return out, dedup_runlen(out, seg)


def fused_extract_count(codes: torch.Tensor, lengths: torch.Tensor,
                        limits: torch.Tensor, k: int, *,
                        canonical: bool = False, mask_ambiguous: bool = False,
                        seg: int = 2, packed_width: int = 0):
    """One batch -> (keys (P_pad, B) int64, counts (P_pad, B) int8).

    codes: (B, L) uint8 codes (code 4 = ambiguous base), or with
    packed_width = L the (B, ceil(L/16)) int32 view of the 2-bit packed
    rows.  lengths, limits: (B,) int32.  seg: power of two <= 16.
    """
    if codes.device.type == "cpu":
        return fused_extract_count_ref(
            codes, lengths, limits, k, canonical=canonical,
            mask_ambiguous=mask_ambiguous, seg=seg,
            packed_width=packed_width)
    if codes.device.type != "cuda":
        raise ValueError(f"no fused_extract_count on {codes.device}")
    B, L, P, P_pad = _shape(codes, k, seg, packed_width)
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
    keys = torch.empty((P_pad, B), dtype=torch.int64, device=codes.device)
    counts = torch.empty((P_pad, B), dtype=torch.int8, device=codes.device)
    with torch.cuda.device(codes.device):
        rc = lib.fused_extract_count_launch(
            codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
            lengths.data_ptr(), limits.data_ptr(), keys.data_ptr(),
            counts.data_ptr(), B, L, k, P, P_pad, int(canonical),
            int(mask_ambiguous), seg, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_extract_count kernel launch failed: "
                           f"cudaError {rc}")
    global launches
    launches += 1
    return keys, counts
