"""2-bit DNA base encoding, the int64 key layouts, and converters to the
uint32 word layout of the table layer.

Bases are 2-bit codes from the parser on: A=0, C=1, G=2, T=3, so integer
order on keys equals byte order on the strings.  On the device a key of
n bases is W = words64(n) int64 words (planes), SENTINEL_KEY (INT64_MAX)
in every word of an invalid lane:

- words 0 .. W - 2 hold HI_BASES = 31 bases each, the first base most
  significant, as the value sum_j code[j] * 4**(30 - j) (at most 62
  bits);
- the last word holds the rest, 1 to 32 bases (at most 31 when W = 1).
  At 32 bases it holds 64 value bits and is stored with its top bit
  flipped (w ^ LO_FLIP), so that signed int64 order on it is the
  unsigned order of its bits.

So W = 1 up to 31 bases, 2 up to 63 (the (hi, lo) pair: hi the first
31 bases, lo the last n - 31), 3 up to 94 and 4 up to 125.  Lexicographic
order over the words, compared as signed int64, equals the order of the
key value, and a real word 0 (at most 62 bits) never equals the
sentinel.  torch has no shifts, compares or `where` on uint32/uint64,
and int64 has all of them.

A gapped L+R key keeps kernel K3's split while l_len, r_len <= 31: two
words, hi the l-mer value and lo the r-mer value (gapped_bases).  Past
31 it is the l_len + r_len-base string L||R in the general layout above.
A layout is described by the bases of each plane (word_bases,
gapped_bases): the key value is the planes' values concatenated, most
significant first, each 2 b bits wide.

The table layer keeps the (M, W32) uint32 most-significant-first word
layout, W32 = words_per_key(n_bases) (one spare bit above the value
bits), so tables, TSV and .npz files are the same in every package that
uses it.  planes_to_u32 / u32_to_planes convert any layout exactly;
keys_i64_to_u32 / keys_u32_to_i64 (one int64) and pairs_to_u32 /
u32_to_pairs (pairs) are their one- and two-word cases.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_ORDER = "ACGT"
AMBIG_CODE = np.uint8(4)          # N / IUPAC codes in skip-invalid mode
SENTINEL_KEY = np.iinfo(np.int64).max
SENTINEL_WORD = np.uint32(0xFFFFFFFF)
HI_BASES = 31                     # bases of one int64 key word; a pair's hi
PAIR_BASES = 63                   # the widest key of two int64 words
LO_FLIP = -(1 << 63)              # a 32-base last word's flipped top bit
_FLIP_U64 = np.uint64(1 << 63)

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


def check_n_bases(n_bases: int) -> None:
    """A key takes at least one base; sort mode has no cap below a read's
    length."""
    if n_bases < 1:
        raise ValueError(f"keys of {n_bases} bases: a key takes at least "
                         "one base")


def words64(n_bases: int) -> int:
    """int64 words of an n_bases-base key in the general layout: 1 up to
    31 bases, 2 up to 63, then one more every 31 bases."""
    check_n_bases(n_bases)
    if n_bases <= HI_BASES:
        return 1
    return max(2, (n_bases - 2) // HI_BASES + 1)


def word_bases(n_bases: int) -> tuple[int, ...]:
    """The bases of each int64 word of an n_bases-base key in the general
    layout: 31 each, the rest (1 to 32) in the last."""
    W = words64(n_bases)
    return (HI_BASES,) * (W - 1) + (n_bases - HI_BASES * (W - 1),)


def gapped_bases(l_len: int, r_len: int) -> tuple[int, ...]:
    """The bases of each int64 plane of a gapped L+R key: K3's split
    (l_len, r_len) while both are at most 31, else the general layout of
    the l_len + r_len-base string L||R."""
    if max(l_len, r_len) <= HI_BASES:
        return (l_len, r_len)
    return word_bases(l_len + r_len)


def bases_bits(bases) -> tuple[int, ...]:
    """Each plane's value bits (sort_words' `bits`): 2 b for b bases, and
    64 (any int64) for a 32-base word, whose top bit is flipped."""
    return tuple(64 if b == 32 else 2 * b for b in bases)


def check_one_word(k: int) -> None:
    """Keys of at most HI_BASES bases: one int64 value."""
    check_n_bases(k)
    if k > HI_BASES:
        raise ValueError(f"k={k}: keys over {HI_BASES} bases are (hi, lo) "
                         "pairs (pairs_to_u32 / u32_to_pairs)")


def key_planes(keys) -> tuple:
    """Keys of one layout as a tuple of int64 planes: (keys,) or the W
    words."""
    return keys if isinstance(keys, tuple) else (keys,)


def pair_r_len(n_bases: int) -> int:
    """lo's bases in the (hi, lo) pair of a contiguous or spaced key of
    32 <= n_bases <= 63; 0 for a key of one int64."""
    if not 1 <= n_bases <= PAIR_BASES:
        raise ValueError(f"{n_bases}-base keys are not one int64 or a "
                         f"pair (1 to {PAIR_BASES} bases)")
    return max(n_bases - HI_BASES, 0)


def plane_bits(n_bases: int) -> tuple[int, ...]:
    """The value bits of each int64 word of a contiguous or spaced key of
    n_bases bases in the general layout (sort_words' `bits`): 62 a full
    word, 2 b for the last word's b bases, 64 at b = 32 (its flipped top
    bit: any int64, a real word of INT64_MAX included)."""
    return bases_bits(word_bases(n_bases))


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


def decode_codes(codes: np.ndarray) -> str:
    """uint8 codes -> ACGT string."""
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def key_words_from_codes(codes: np.ndarray, n_bases: int | None = None
                         ) -> np.ndarray:
    """Code vectors (..., n) -> their (..., W) uint32 key words, most
    significant first (host-side helper)."""
    codes = np.asarray(codes, dtype=np.uint32)
    k = codes.shape[-1] if n_bases is None else n_bases
    if codes.shape[-1] != k:
        raise ValueError(f"{codes.shape[-1]} codes for a {k}-base key")
    W = words_per_key(k)
    words = np.zeros(codes.shape[:-1] + (W,), dtype=np.uint32)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        words[..., W - 1 - bitpos // 32] |= (
            (codes[..., j] & np.uint32(3)) << np.uint32(bitpos % 32))
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


def decode_key_words_to_lines(words: np.ndarray, n_bases: int) -> bytes:
    """Batch-decode (M, W) key words into newline-terminated ASCII bytes,
    n_bases characters + '\\n' a line, in row order (the parity dump)."""
    words = np.atleast_2d(np.asarray(words, dtype=np.uint32))
    from ..pipeline.nativeagg import decode_rows
    rows = decode_rows(words, n_bases, newline=True)
    if rows is not None:
        return rows.tobytes()
    codes = codes_from_key_words(words, n_bases)
    out = np.empty((codes.shape[0], n_bases + 1), dtype=np.uint8)
    out[:, :n_bases] = _CODE_TO_ASCII[codes]
    out[:, n_bases] = ord("\n")
    return out.tobytes()


def revcomp_str(seq: str) -> str:
    """Reverse complement of an ACGT string (KeyError on any other
    character, as kmer_tpu's)."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[b] for b in reversed(seq))


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
    check_one_word(k)
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
    check_one_word(k)
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


def _shl128(vhi, vlo, n: int):
    """(vhi, vlo) uint64 halves of a 128-bit value shifted left by 0 < n <
    64."""
    n = np.uint64(n)
    return (vhi << n) | (vlo >> (np.uint64(64) - n)), vlo << n


def _bits32(vhi, vlo, p: int):
    """Bits [p, p + 32) of 128-bit values as uint32, 0 <= p <= 96."""
    if p >= 64:
        return (vhi >> np.uint64(p - 64)).astype(np.uint32)
    if p == 0:
        return vlo.astype(np.uint32)
    return ((vlo >> np.uint64(p))
            | (vhi << np.uint64(64 - p))).astype(np.uint32)


def words_from_tpu_repacked(rwords, n_bases: int):
    """kmer_tpu's repacked uint32 sort-layout words (kmer_tpu/ops/count.py
    repack_words; fused_extract.py _chunks_to_repacked) -> this port's
    keys of the same shape: int64 keys for n_bases <= 31, the (hi, lo)
    int64 pair beyond; SENTINEL_KEY on invalid lanes.  The layout: W = 1,
    the key word as it is; else s = 2 * n_bases - 32 (W - 1) bits, words
    0 .. W - 2 hold the key's top 32 (W - 1) bits and word W - 1 its s
    low bits, or, for s = 0 (16, 32 and 48 bases), words 0 .. W - 2 hold
    the whole key and word W - 1 is a 0 flag; word W - 1 is SENTINEL_WORD
    on invalid lanes."""
    pair_r_len(n_bases)
    W = words_per_key(n_bases)
    rw = [np.asarray(w, dtype=np.uint32) for w in rwords]
    if len(rw) != W:
        raise ValueError(f"{len(rw)} repacked words for {n_bases} bases "
                         f"(W = {W})")
    dead = rw[-1] == SENTINEL_WORD
    s = 2 * n_bases - 32 * (W - 1)
    if n_bases <= HI_BASES:
        v = rw[0].astype(np.int64)
        if W == 2 and s > 0:
            v = (v << s) | rw[1].astype(np.int64)
        return np.where(dead, SENTINEL_KEY, v)
    shape = rw[0].shape
    vhi = np.zeros(rw[0].size, np.uint64)
    vlo = np.zeros(rw[0].size, np.uint64)
    for w in rw[:-1]:
        vhi, vlo = _shl128(vhi, vlo, 32)
        vlo |= w.reshape(-1).astype(np.uint64)
    if s:
        vhi, vlo = _shl128(vhi, vlo, s)
        vlo |= rw[-1].reshape(-1).astype(np.uint64)
    hi, lo = value_to_pair(vhi, vlo, pair_r_len(n_bases))
    dead = dead.reshape(-1)
    return (np.where(dead, SENTINEL_KEY, hi).reshape(shape),
            np.where(dead, SENTINEL_KEY, lo).reshape(shape))


def words_to_tpu_repacked(keys, n_bases: int) -> list[np.ndarray]:
    """Inverse of words_from_tpu_repacked: int64 keys, or (hi, lo) pairs
    beyond 31 bases (SENTINEL_KEY on invalid lanes) -> kmer_tpu's W
    repacked uint32 words, all SENTINEL_WORD on invalid lanes (as
    kmer_tpu's kernels write them)."""
    pair_r_len(n_bases)
    W = words_per_key(n_bases)
    s = 2 * n_bases - 32 * (W - 1)
    if n_bases > HI_BASES:
        hi, lo = (np.asarray(x, dtype=np.int64) for x in keys)
        dead = hi == SENTINEL_KEY
        vhi, vlo = pairs_to_value(hi, lo, pair_r_len(n_bases))
        words = [_bits32(vhi, vlo, 2 * n_bases - 32 * (j + 1))
                 for j in range(W - 1)]
        words.append(_bits32(vhi, vlo, 0) & np.uint32((1 << s) - 1) if s
                     else np.zeros(vlo.shape, np.uint32))
        return [np.where(dead, SENTINEL_WORD, w.reshape(dead.shape))
                for w in words]
    keys = np.asarray(keys, dtype=np.int64)
    dead = keys == SENTINEL_KEY
    u = np.where(dead, 0, keys).view(np.uint64)
    if W == 1:
        words = [u.astype(np.uint32)]
    elif s == 0:
        words = [u.astype(np.uint32), np.zeros(keys.shape, np.uint32)]
    else:
        words = [(u >> np.uint64(s)).astype(np.uint32),
                 (u & np.uint64((1 << s) - 1)).astype(np.uint32)]
    return [np.where(dead, SENTINEL_WORD, w) for w in words]


def pairs_to_value(hi: np.ndarray, lo: np.ndarray, r_len: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) int64 pairs -> the key value hi * 4**r_len + lo as 128
    bits: (vhi, vlo) uint64; at r_len = 32 the stored lo's flipped top
    bit is taken off.  Sentinel pairs give garbage; callers mask them."""
    hi = np.asarray(hi, dtype=np.int64).reshape(-1).view(np.uint64)
    lo = np.asarray(lo, dtype=np.int64).reshape(-1).view(np.uint64)
    if r_len == 32:
        return hi, lo ^ _FLIP_U64
    s = 2 * r_len                                    # 2 <= s <= 62
    return hi >> np.uint64(64 - s), (hi << np.uint64(s)) | lo


def value_to_pair(vhi: np.ndarray, vlo: np.ndarray, r_len: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of pairs_to_value: 128-bit values (vhi, vlo) uint64 ->
    (hi, lo) int64, lo's top bit flipped at r_len = 32."""
    if r_len == 32:
        return vhi.view(np.int64), (vlo ^ _FLIP_U64).view(np.int64)
    s = np.uint64(2 * r_len)
    lo = (vlo & ((np.uint64(1) << s) - np.uint64(1))).view(np.int64)
    hi = ((vlo >> s) | (vhi << (np.uint64(64) - s))).view(np.int64)
    return hi, lo


def pairs_to_u32(hi: np.ndarray, lo: np.ndarray, l_len: int, r_len: int
                 ) -> np.ndarray:
    """(M,) int64 pairs -> (M, W) uint32 most-significant-first words, W
    = words_per_key(l_len + r_len); sentinel pairs (hi == SENTINEL_KEY)
    map to all-0xFFFFFFFF words.  A contiguous key of 32..63 bases is
    the pair at l_len = 31 (planes_to_u32 of the layout (l_len, r_len))."""
    pair_r_len(l_len + r_len)
    return planes_to_u32((hi, lo), (l_len, r_len))


def u32_to_pairs(words: np.ndarray, l_len: int, r_len: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of pairs_to_u32: (M, W) uint32 words -> (hi, lo) int64;
    all-0xFFFFFFFF (sentinel) rows map to SENTINEL_KEY in both."""
    pair_r_len(l_len + r_len)
    hi, lo = u32_to_planes(words, (l_len, r_len))
    return hi, lo


def fused_columns(n_bases: int) -> int:
    """uint64 columns of an n_bases-base key fused for the table layer:
    ceil(W32 / 2), W32 = words_per_key(n_bases)."""
    return (words_per_key(n_bases) + 1) // 2


def planes_to_chunks(planes, bases) -> list[np.ndarray]:
    """Key planes of a layout (int64 arrays of one shape; bases: each
    plane's bases, most significant first) -> the key value as
    fused_columns(sum(bases)) uint64 chunks, least significant first
    (flattened).  A 32-base plane's flipped top bit is taken off.
    Sentinel lanes give garbage; callers mask them."""
    n_bases = sum(bases)
    planes = [np.asarray(p, dtype=np.int64).reshape(-1).view(np.uint64)
              for p in planes]
    chunks = [np.zeros(planes[0].shape, np.uint64)
              for _ in range(fused_columns(n_bases))]
    pos = 0
    for u, b in zip(reversed(planes), reversed(tuple(bases))):
        if b == 32:
            u = u ^ _FLIP_U64
        c, s = divmod(pos, 64)
        chunks[c] |= u << np.uint64(s)
        if s and s + 2 * b > 64:
            chunks[c + 1] |= u >> np.uint64(64 - s)
        pos += 2 * b
    return chunks


def chunks_to_planes(chunks, bases) -> list[np.ndarray]:
    """Inverse of planes_to_chunks: uint64 value chunks (least significant
    first) -> int64 planes of the layout, a 32-base plane's top bit
    flipped."""
    pos = 2 * sum(bases)
    out = []
    for b in bases:
        pos -= 2 * b
        c, s = divmod(pos, 64)
        v = chunks[c] >> np.uint64(s)
        if s and s + 2 * b > 64:
            v = v | (chunks[c + 1] << np.uint64(64 - s))
        if b < 32:
            v = v & np.uint64((1 << (2 * b)) - 1)
        else:
            v = v ^ _FLIP_U64
        out.append(v.view(np.int64))
    return out


def chunks_to_u32(chunks, n_bases: int) -> np.ndarray:
    """uint64 value chunks (least significant first) -> (M, W32) uint32
    words, most significant first."""
    W = words_per_key(n_bases)
    out = np.empty((len(chunks[0]), W), np.uint32)
    for j in range(W):
        c, half = divmod(W - 1 - j, 2)           # 32-bit chunk W - 1 - j
        out[:, j] = chunks[c] >> np.uint64(32 * half)   # astype cuts
    return out


def u32_to_chunks(words: np.ndarray, n_bases: int) -> list[np.ndarray]:
    """Inverse of chunks_to_u32."""
    W = words_per_key(n_bases)
    words = np.asarray(words, dtype=np.uint32)
    if words.ndim != 2 or words.shape[1] != W:
        raise ValueError(f"keys of shape {words.shape} are not (M, {W}) "
                         f"words for {n_bases} bases")
    chunks = [np.zeros(len(words), np.uint64)
              for _ in range(fused_columns(n_bases))]
    for j in range(W):
        c, half = divmod(W - 1 - j, 2)
        chunks[c] |= words[:, j].astype(np.uint64) << np.uint64(32 * half)
    return chunks


def planes_to_u32(planes, bases) -> np.ndarray:
    """Key planes of a layout -> (M, W32) uint32 most-significant-first
    words of the sum(bases)-base key; lanes whose word 0 is SENTINEL_KEY
    map to all-0xFFFFFFFF words."""
    n_bases = sum(bases)
    out = chunks_to_u32(planes_to_chunks(planes, bases), n_bases)
    sent = np.asarray(planes[0]).reshape(-1) == SENTINEL_KEY
    if sent.any():
        out[sent] = SENTINEL_WORD
    return out


def u32_to_planes(words: np.ndarray, bases) -> list[np.ndarray]:
    """Inverse of planes_to_u32: (M, W32) uint32 words -> int64 planes of
    the layout; all-0xFFFFFFFF (sentinel) rows map to SENTINEL_KEY in
    every plane."""
    words = np.asarray(words, dtype=np.uint32)
    planes = chunks_to_planes(u32_to_chunks(words, sum(bases)), bases)
    sent = (words == SENTINEL_WORD).all(axis=1)
    return [np.where(sent, SENTINEL_KEY, p) for p in planes]
