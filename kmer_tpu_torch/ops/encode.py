"""2-bit DNA base encoding, the int64 key layout, and converters to the
uint32 word layout of the table layer.

Bases are 2-bit codes from the parser on: A=0, C=1, G=2, T=3, so integer
order on keys equals byte order on the strings.  On the device a k-mer
key for k <= 31 is ONE int64 holding the 2k-bit value

    value = sum_j code[j] * 4**(k-1-j)      (first base most significant)

and invalid lanes hold SENTINEL_KEY (INT64_MAX), which sorts after every
real key (at most 62 bits).  torch has no shifts, compares or `where` on
uint32/uint64, and int64 has all of them.

The table layer keeps the (M, W) uint32 most-significant-first word
layout, W = words_per_key(k) (one spare bit above the 2k value bits), so
tables, TSV and .npz files are the same in every package that uses it.
keys_i64_to_u32 / keys_u32_to_i64 convert between the two exactly.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_ORDER = "ACGT"
AMBIG_CODE = np.uint8(4)          # N / IUPAC codes in skip-invalid mode
SENTINEL_KEY = np.iinfo(np.int64).max
SENTINEL_WORD = np.uint32(0xFFFFFFFF)
MAX_K = 31                        # one int64 key word

_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASE_ORDER):
    _LUT[ord(_b)] = _i
    _LUT[ord(_b.lower())] = _i
for _b in "NRYKMSWBDHVU":
    _LUT[ord(_b)] = AMBIG_CODE
    _LUT[ord(_b.lower())] = AMBIG_CODE

_CODE_TO_ASCII = np.frombuffer(BASE_ORDER.encode(), dtype=np.uint8).copy()


class InvalidBaseError(ValueError):
    """Raised on non-ACGT input when ambiguous bases are not allowed."""


def words_per_key(n_bases: int) -> int:
    """Number of uint32 words for an n_bases-mer key (incl. sentinel bit)."""
    return (2 * n_bases + 1 + 31) // 32


def check_k(k: int) -> None:
    """Keys wider than one int64 word are not ported yet."""
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: only 1 <= k <= {MAX_K} (one int64 key word) is "
            "ported; two-word keys are ROADMAP Queue 1 item 5 (two-word "
            "int64 keys, 32 <= k <= 63)")


def encode_seq(seq: str | bytes, allow_ambiguous: bool = False) -> np.ndarray:
    """ASCII sequence -> uint8 codes (plus AMBIG_CODE when
    allow_ambiguous); raises InvalidBaseError otherwise."""
    raw = np.frombuffer(seq.encode() if isinstance(seq, str) else seq,
                        dtype=np.uint8)
    codes = _LUT[raw]
    bad_cut = 255 if allow_ambiguous else AMBIG_CODE
    if codes.max(initial=0) >= bad_cut:
        bad = int(np.argmax(codes >= bad_cut))
        raise InvalidBaseError(
            f"invalid base {chr(int(raw[bad]))!r} at position {bad}")
    return codes


def key_words_from_codes(codes: np.ndarray, n_bases: int | None = None
                         ) -> np.ndarray:
    """One code vector -> its (W,) uint32 key words, most significant
    first (host-side helper)."""
    codes = np.asarray(codes, dtype=np.uint64)
    k = len(codes) if n_bases is None else n_bases
    if len(codes) != k:
        raise ValueError(f"{len(codes)} codes for a {k}-base key")
    W = words_per_key(k)
    words = np.zeros(W, dtype=np.uint32)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        words[W - 1 - bitpos // 32] |= np.uint32(
            (int(codes[j]) & 3) << (bitpos % 32))
    return words


def codes_from_key_words(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Inverse of key_words_from_codes: (..., W) uint32 -> (..., n_bases)
    uint8."""
    words = np.asarray(words, dtype=np.uint32)
    W = words.shape[-1]
    if W != words_per_key(n_bases):
        raise ValueError(f"{W} key words for {n_bases} bases")
    out = np.empty(words.shape[:-1] + (n_bases,), dtype=np.uint8)
    for j in range(n_bases):
        bitpos = 2 * (n_bases - 1 - j)
        out[..., j] = ((words[..., W - 1 - bitpos // 32]
                        >> np.uint32(bitpos % 32)) & np.uint32(3))
    return out


def decode_key_words(words: np.ndarray, n_bases: int) -> list[str]:
    """Batch-decode (M, W) key words into ACGT strings."""
    codes = codes_from_key_words(np.atleast_2d(words), n_bases)
    return [row.tobytes().decode() for row in _CODE_TO_ASCII[codes]]


def decode_key_words_to_bytes(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Batch-decode (M, W) key words into an (M,) |S{n_bases} array
    (native multithreaded pass when available)."""
    words = np.atleast_2d(np.asarray(words, dtype=np.uint32))
    from ..pipeline.nativeagg import decode_rows
    rows = decode_rows(words, n_bases, newline=False)
    if rows is not None:
        return rows.reshape(-1).view(f"S{n_bases}")
    codes = codes_from_key_words(words, n_bases)
    raw = np.ascontiguousarray(_CODE_TO_ASCII[codes]).tobytes()
    return np.frombuffer(raw, dtype=f"S{n_bases}")


def unpack_codes_i32(packed: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of the host 2-bit packer (io.fasta packed batches):
    (B, ceil(L/16)) int32 rows, 16 bases per word with the first base in
    the most significant pair -> (B, L) uint8 codes.  The words are the
    packer's uint32 bits viewed as int32; the arithmetic shift's sign
    copies are cut off by the & 3."""
    B, Lw = packed.shape
    shifts = torch.arange(30, -1, -2, dtype=torch.int32, device=packed.device)
    ex = (packed[:, :, None] >> shifts) & 3
    return ex.reshape(B, Lw * 16)[:, :L].to(torch.uint8)


def keys_i64_to_u32(keys: np.ndarray, k: int) -> np.ndarray:
    """(M,) int64 keys -> (M, W) uint32 most-significant-first words.
    SENTINEL_KEY maps to all-0xFFFFFFFF words.  For k = 16 the top word
    is empty (W = 2 because of the spare sentinel bit)."""
    check_k(k)
    keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
    u = keys.view(np.uint64)
    sent = keys == SENTINEL_KEY
    if sent.any():
        u = np.where(sent, np.uint64(0xFFFFFFFFFFFFFFFF), u)
    if words_per_key(k) == 1:
        return u.astype(np.uint32).reshape(-1, 1)
    out = np.empty((len(u), 2), np.uint32)
    out[:, 0] = u >> np.uint64(32)
    out[:, 1] = u.astype(np.uint32)
    return out


def keys_u32_to_i64(words: np.ndarray, k: int) -> np.ndarray:
    """(M, W) uint32 most-significant-first words -> (M,) int64 keys;
    all-0xFFFFFFFF (sentinel) rows map to SENTINEL_KEY."""
    check_k(k)
    words = np.asarray(words, dtype=np.uint32)
    W = words_per_key(k)
    if words.ndim != 2 or words.shape[1] != W:
        raise ValueError(f"keys of shape {words.shape} are not (M, {W}) "
                         f"words for k={k}")
    v = words[:, 0].astype(np.uint64)
    if W == 2:
        v = (v << np.uint64(32)) | words[:, 1]
    sent = (words == SENTINEL_WORD).all(axis=1)
    return np.where(sent, SENTINEL_KEY, v.view(np.int64))
