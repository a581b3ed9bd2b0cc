"""Row-layout k-mer extraction with no collapse (the unfused count step's
front half), as one hand-written Hopper kernel (csrc/extract.cu) and its
plain torch version.

Counterpart of kmer_tpu/ops/pallas/extract.py `extract_repacked` (kernel
K7).  kmer_tpu's kernel returns each key as the (top, bot) uint32 words
of its sort layout and takes only 17 <= k <= 31 without ambiguous codes;
here a key is one int64 (ops/encode), so the kernel takes every k <= 31,
canonical or not, and the ambiguity mask of skip-invalid mode.  Output:
keys (B, P) int64, P = L - k + 1, row-major, SENTINEL_KEY on invalid
lanes (ops/extract validity); ops/encode.words_to_tpu_repacked gives
kmer_tpu's (top, bot).

extract_keys dispatches on where its inputs lie: CPU tensors run the
plain version, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..canonical import canonical_kmer_lanes
from ..encode import check_k, unpack_codes_i32
from ..extract import kmer_lanes

SOURCE = "kmer_tpu_torch/csrc/extract.cu"
REPLACES = "kmer_tpu/ops/pallas/extract.py:88"
# calls of extract_keys that launched the kernel (the plain version on CPU
# tensors does not count)
launches = 0
_lib = None


def load():
    global _lib
    if _lib is None:
        from ...utils.build import CSRC_DIR, build_cdll
        lib = build_cdll(os.path.join(CSRC_DIR, "extract.cu"),
                         "kmer_extract", cuda=True)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.extract_launch.restype = i
        lib.extract_launch.argtypes = [vp, i, i, vp, vp, vp, i, i, i, i, i,
                                       vp]
        _lib = lib
    return _lib


def _shape(codes: torch.Tensor, k: int, packed_width: int):
    """(B, L, P) of a batch; packed rows hold ceil(L/16) words."""
    check_k(k)
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
    return B, L, P


def extract_keys_ref(codes: torch.Tensor, lengths: torch.Tensor,
                     limits: torch.Tensor, k: int, *, canonical: bool = False,
                     mask_ambiguous: bool = False,
                     packed_width: int = 0) -> torch.Tensor:
    """Plain torch version: ops/extract.kmer_lanes or
    ops/canonical.canonical_kmer_lanes."""
    _shape(codes, k, packed_width)
    if packed_width:
        codes = unpack_codes_i32(codes, packed_width)
    fn = canonical_kmer_lanes if canonical else kmer_lanes
    keys, _ = fn(codes, lengths, k, limits=limits,
                 mask_ambiguous=mask_ambiguous)
    return keys


def extract_keys(codes: torch.Tensor, lengths: torch.Tensor,
                 limits: torch.Tensor, k: int, *, canonical: bool = False,
                 mask_ambiguous: bool = False,
                 packed_width: int = 0) -> torch.Tensor:
    """One batch -> keys (B, P) int64, SENTINEL_KEY on invalid lanes.

    codes: (B, L) uint8 codes (code 4 = ambiguous base), or with
    packed_width = L the (B, ceil(L/16)) int32 view of the 2-bit packed
    rows.  lengths, limits: (B,) int32.
    """
    if codes.device.type == "cpu":
        return extract_keys_ref(codes, lengths, limits, k,
                                canonical=canonical,
                                mask_ambiguous=mask_ambiguous,
                                packed_width=packed_width)
    if codes.device.type != "cuda":
        raise ValueError(f"no extract_keys on {codes.device}")
    B, L, P = _shape(codes, k, packed_width)
    want = torch.int32 if packed_width else torch.uint8
    if codes.dtype != want or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D {want} tensor, "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    for name, t in (("lengths", lengths), ("limits", limits)):
        if (t.device != codes.device or t.dtype != torch.int32
                or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {codes.device}")
    keys = torch.empty((B, P), dtype=torch.int64, device=codes.device)
    if B == 0:
        return keys
    lib = load()
    with torch.cuda.device(codes.device):
        rc = lib.extract_launch(
            codes.data_ptr(), int(bool(packed_width)), codes.shape[1],
            lengths.data_ptr(), limits.data_ptr(), keys.data_ptr(), B, L, k,
            int(canonical), int(mask_ambiguous),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extract kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return keys
