"""2-bit DNA base encoding, the int64 key layouts, and converters to the
uint32 word layout of the table layer.

Bases are 2-bit codes from the parser on: A=0, C=1, G=2, T=3, so integer
order on keys equals byte order on the strings.  On the device a k-mer
key for k <= 31 is ONE int64 holding the 2k-bit value

    value = sum_j code[j] * 4**(k-1-j)      (first base most significant)

and invalid lanes hold SENTINEL_KEY (INT64_MAX), which sorts after every
real key (at most 62 bits).  torch has no shifts, compares or `where` on
uint32/uint64, and int64 has all of them.

A wider key is the int64 PAIR (hi, lo), SENTINEL_KEY in both on invalid
lanes:
- a gapped L+R key (l_len, r_len <= 31): hi the l-mer value, lo the
  r-mer value;
- a contiguous or spaced key of 32 <= n <= 63 bases: hi the value of its
  first HI_BASES = 31 bases, lo the value of the last r_len = n - 31, so
  it is the gapped pair at l_len = 31.
Lexicographic order on (hi, lo) equals numeric order on the key value
hi * 4**r_len + lo, and a real hi (at most 62 bits) never equals the
sentinel.  At r_len = 32 lo holds 64 value bits; it is stored with its
top bit flipped (lo ^ LO_FLIP), so that signed int64 order on lo is the
unsigned order of its bits.  pairs_to_value and value_to_pair take the
flip off and put it back.

The table layer keeps the (M, W) uint32 most-significant-first word
layout, W = words_per_key(n_bases) (one spare bit above the value bits),
so tables, TSV and .npz files are the same in every package that uses
it.  keys_i64_to_u32 / keys_u32_to_i64 (one int64) and
pairs_to_u32 / u32_to_pairs (pairs) convert exactly.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_ORDER = "ACGT"
AMBIG_CODE = np.uint8(4)          # N / IUPAC codes in skip-invalid mode
SENTINEL_KEY = np.iinfo(np.int64).max
SENTINEL_WORD = np.uint32(0xFFFFFFFF)
MAX_K = 63                        # contiguous and spaced keys (K1, K7)
HI_BASES = 31                     # bases of one int64 key word; a pair's hi
MAX_KEY_BASES = 63                # the table layer: W <= 4 uint32 words
LO_FLIP = -(1 << 63)              # lo's top bit, flipped when r_len == 32
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


def check_key_width(n_bases: int) -> None:
    """Key widths the table layer takes: 1..63 bases, W <= 4 words."""
    if not 1 <= n_bases <= MAX_KEY_BASES:
        raise ValueError(f"{n_bases}-base keys: the table layer takes 1 "
                         f"to {MAX_KEY_BASES} bases (W <= 4 words); keys "
                         "over 63 bases are ROADMAP Queue 1 item 18")


def check_k(k: int) -> None:
    """Contiguous (and spaced) keys take 1 to 63 bases: one int64 up to
    31, an int64 (hi, lo) pair up to 63."""
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: only 1 <= k <= {MAX_K} (an int64 key or (hi, lo) "
            "pair) is ported; keys over 63 bases are ROADMAP Queue 1 item "
            "18 (keys over 63 bases)")


def check_one_word(k: int) -> None:
    """Keys of at most HI_BASES bases: one int64 value."""
    check_k(k)
    if k > HI_BASES:
        raise ValueError(f"k={k}: keys over {HI_BASES} bases are (hi, lo) "
                         "pairs (pairs_to_u32 / u32_to_pairs)")


def key_planes(keys) -> tuple:
    """Keys of one layout as a tuple of int64 planes: (keys,) or (hi, lo)."""
    return keys if isinstance(keys, tuple) else (keys,)


def pair_r_len(n_bases: int) -> int:
    """lo's bases in the (hi, lo) pair of a contiguous or spaced key of
    32 <= n_bases <= 63; 0 for a key of one int64."""
    check_k(n_bases)
    return max(n_bases - HI_BASES, 0)


def plane_bits(n_bases: int) -> tuple[int, ...]:
    """The value bits of each int64 key plane of a contiguous or spaced
    key of n_bases bases (sort_words' `bits`): (2 n_bases,), or (62,
    2 r_len) for a pair; at r_len = 32 lo's top bit is flipped and 64
    means any int64, a real lo of INT64_MAX included."""
    r_len = pair_r_len(n_bases)
    return (2 * HI_BASES, 2 * r_len) if r_len else (2 * n_bases,)


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
    check_k(n_bases)
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
    check_k(n_bases)
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


def value_to_words(vhi: np.ndarray, vlo: np.ndarray, W: int) -> np.ndarray:
    """128-bit key values (vhi, vlo) uint64 -> (M, W) uint32 words, most
    significant first (W <= 4; the value must fit 32 W bits)."""
    chunks = (vlo, vlo >> np.uint64(32), vhi, vhi >> np.uint64(32))
    out = np.empty((len(vlo), W), np.uint32)
    for j in range(W):
        out[:, j] = chunks[W - 1 - j]            # astype cuts to 32 bits
    return out


def pairs_to_u32(hi: np.ndarray, lo: np.ndarray, l_len: int, r_len: int
                 ) -> np.ndarray:
    """(M,) int64 pairs -> (M, W) uint32 most-significant-first words, W
    = words_per_key(l_len + r_len); sentinel pairs (hi == SENTINEL_KEY)
    map to all-0xFFFFFFFF words.  A contiguous key of 32..63 bases is
    the pair at l_len = 31."""
    n_bases = l_len + r_len
    check_key_width(n_bases)
    out = value_to_words(*pairs_to_value(hi, lo, r_len),
                         words_per_key(n_bases))
    sent = np.asarray(hi).reshape(-1) == SENTINEL_KEY
    if sent.any():
        out[sent] = SENTINEL_WORD
    return out


def u32_to_pairs(words: np.ndarray, l_len: int, r_len: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of pairs_to_u32: (M, W) uint32 words -> (hi, lo) int64;
    all-0xFFFFFFFF (sentinel) rows map to SENTINEL_KEY in both."""
    n_bases = l_len + r_len
    check_key_width(n_bases)
    W = words_per_key(n_bases)
    words = np.asarray(words, dtype=np.uint32)
    if words.ndim != 2 or words.shape[1] != W:
        raise ValueError(f"keys of shape {words.shape} are not (M, {W}) "
                         f"words for {n_bases} bases")
    u64 = [np.zeros(len(words), np.uint64) for _ in range(2)]   # vhi, vlo
    for j in range(W):
        i = W - 1 - j                            # 32-bit chunk index
        u64[1 - i // 2] |= (words[:, j].astype(np.uint64)
                            << np.uint64(32 * (i % 2)))
    hi, lo = value_to_pair(*u64, r_len)
    sent = (words == SENTINEL_WORD).all(axis=1)
    return (np.where(sent, SENTINEL_KEY, hi),
            np.where(sent, SENTINEL_KEY, lo))
