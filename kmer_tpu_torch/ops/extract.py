"""Plain torch k-mer extraction: the reference semantics that the
Hopper kernels (ops/kernels/fused_extract, ops/kernels/extract,
ops/kernels/fused_gapped) are held against.

A batch is a (B, L) uint8 code matrix plus per-row lengths and start
limits.  The key of window p of row b is built from shifted slices of
the code matrix (ops/encode key layout): one int64 a lane for keys of up
to 31 bases, the (hi, lo) int64 pair for 32 to 63, and W = words64(n)
int64 words for any wider key.  Lane p of row b is
valid when

    p <= lengths[b] - span,  p < limits[b],  and (mask_ambiguous) no
    code >= 4 at a base of the key;

invalid lanes carry SENTINEL_KEY (in every word).  The span is k for
contiguous k-mers and the mask's length for spaced seeds, whose key is
the bases at the mask's '1' offsets (spaced_lanes).  gapped_lanes gives
the gapped L+R chunk keys in the planes of ops/encode.gapped_bases.
"""

from __future__ import annotations

import torch

from .encode import (LO_FLIP, PAIR_BASES, SENTINEL_KEY, check_n_bases,
                     gapped_bases, word_bases)

def valid_mask(B: int, P: int, lengths: torch.Tensor, span: int,
               limits: torch.Tensor | None, device) -> torch.Tensor:
    """(B, P) bool: window start p lies inside its row and its limit."""
    pos = torch.arange(P, device=device, dtype=torch.int32)[None, :]
    valid = pos <= (lengths.to(torch.int32)[:, None] - span)
    if limits is not None:
        valid = valid & (pos < limits.to(torch.int32)[:, None])
    return valid


def _plane_value(planes):
    """The value of (B, P) int64 code planes (values 0..3), the first
    most significant; at most 31 planes."""
    v = torch.zeros_like(planes[0])
    for p in planes:
        v = (v << 2) | p
    return v


def _pack_key(slices):
    """The key of a list of (B, P) int64 code planes (values 0..3), most
    significant base first, in the general layout of ops/encode: one
    int64 for at most 31 planes, else the tuple of words64(n) words (a
    32-base last word's top bit flipped)."""
    bases = word_bases(len(slices))
    if len(bases) == 1:
        return _plane_value(slices)
    words, q = [], 0
    for b in bases:
        part = slices[q:q + b]
        q += b
        if b < 32:
            words.append(_plane_value(part))
            continue
        # 32 bases: the first one's high bit is bit 63, stored flipped
        top = part[0] ^ 2
        w = _plane_value(part[1:]) | ((top & 1) << 62)
        words.append(torch.where(top >= 2, w | LO_FLIP, w))
    return tuple(words)


def _key_min(a, b):
    """Lane-wise min of two keys of one layout (int64, or a tuple of
    words compared lexicographically)."""
    if not isinstance(a, tuple):
        return torch.minimum(a, b)
    take_b = torch.zeros_like(a[0], dtype=torch.bool)
    tied = torch.ones_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        take_b |= tied & (y < x)
        tied &= y == x
    return tuple(torch.where(take_b, y, x) for x, y in zip(a, b))


def _with_sentinel(keys, valid):
    """SENTINEL_KEY in every word of the invalid lanes."""
    if isinstance(keys, tuple):
        return tuple(torch.where(valid, w, SENTINEL_KEY) for w in keys)
    return torch.where(valid, keys, SENTINEL_KEY)


def window_keys(codes: torch.Tensor, lengths: torch.Tensor,
                positions, *, limits: torch.Tensor | None = None,
                sentinel: bool = True, mask_ambiguous: bool = False,
                canonical: bool = False):
    """The key of the bases at window offsets `positions` (ascending,
    positions[0] = 0) of every window start: (keys, valid), keys an
    int64 (B, P) tensor or a tuple of words64(n) of them (the (hi, lo)
    pair up to 63 bases), P = L - span + 1,
    span = positions[-1] + 1.  canonical: the min of the key and the
    reverse complement of its bases (base i complemented to position
    n - 1 - i), which is the strand-min for contiguous windows and
    palindromic masks."""
    B, L = codes.shape
    span = positions[-1] + 1
    assert L >= span, f"batch width {L} < window span {span}"
    P = L - span + 1
    c = codes.to(torch.int64)
    amb = None
    if mask_ambiguous:
        amb = torch.zeros((B, P), dtype=torch.bool, device=codes.device)
        for j in positions:
            amb |= c[:, j:j + P] >= 4
    c = c & 3
    keys = _pack_key([c[:, j:j + P] for j in positions])
    if canonical:
        c3 = 3 - c
        keys = _key_min(keys, _pack_key([c3[:, j:j + P]
                                         for j in reversed(positions)]))
    valid = valid_mask(B, P, lengths, span, limits, codes.device)
    if mask_ambiguous:
        valid &= ~amb
    if sentinel:
        keys = _with_sentinel(keys, valid)
    return keys, valid


def kmer_lanes(codes: torch.Tensor, lengths: torch.Tensor, k: int, *,
               limits: torch.Tensor | None = None, sentinel: bool = True,
               mask_ambiguous: bool = False):
    """All k-mer keys of every read in a batch.

    Returns (keys, valid): keys (B, P) int64 with P = L - k + 1 for k <=
    31, else the tuple of words64(k) (B, P) int64 planes -- the pair (hi,
    lo) for 32 <= k <= 63 -- (invalid lanes = SENTINEL_KEY unless
    sentinel=False), valid (B, P) bool.
    """
    check_n_bases(k)
    return window_keys(codes, lengths, range(k), limits=limits,
                       sentinel=sentinel, mask_ambiguous=mask_ambiguous)


def parse_seed_mask(mask: str) -> tuple[int, ...]:
    """A spaced-seed mask ('1' = match, '0' = don't-care) -> the tuple of
    match offsets.  It must start and end with '1' (leading or trailing
    don't-cares would only shift the windows)."""
    if not mask or set(mask) - {"0", "1"}:
        raise ValueError(f"seed mask must be nonempty 0/1, got {mask!r}")
    if mask[0] != "1" or mask[-1] != "1":
        raise ValueError("seed mask must start and end with '1'")
    return tuple(i for i, ch in enumerate(mask) if ch == "1")


def mask_from_positions(positions) -> str:
    """Inverse of parse_seed_mask (span = positions[-1] + 1)."""
    sel = set(positions)
    return "".join("1" if j in sel else "0" for j in range(positions[-1] + 1))


def seed_mask_palindromic(mask: str) -> bool:
    """Canonical (strand-min) spaced keys are defined only when the mask
    equals its reverse: the reverse complement of a window then selects
    the same offsets."""
    return mask == mask[::-1]


def check_window(n_bases: int, positions=None,
                 canonical: bool = False) -> int:
    """Check a key of n_bases bases and return its window span: contiguous
    (positions None, any n_bases >= 1) or a spaced seed's n_bases window
    offsets -- ascending from 0, at most PAIR_BASES of them (kmer_tpu's
    limit), a palindromic mask when canonical.  The one
    check of a seed: KmerConfig, spaced_lanes and the K1 and K7 wrappers
    call it, and the kernels take what it passed."""
    if positions is None:
        check_n_bases(n_bases)
        return n_bases
    positions = tuple(positions)
    if (len(positions) != n_bases or not positions or positions[0] != 0
            or any(b <= a for a, b in zip(positions, positions[1:]))):
        raise ValueError(f"positions {positions} are not {n_bases} "
                         "ascending window offsets from 0")
    if n_bases > PAIR_BASES:
        raise ValueError(f"seed mask selects more than {PAIR_BASES} bases")
    mask = mask_from_positions(positions)
    if canonical and not seed_mask_palindromic(mask):
        raise ValueError("canonical spaced seeds need a palindromic mask, "
                         f"got {mask!r}")
    return positions[-1] + 1


def seed_runs(positions) -> list[tuple[int, int, int]]:
    """A spaced seed's runs of consecutive selected offsets, in key order,
    as (shift, width, place): the run's `width` bases sit at bits
    [shift, shift + 2 width) of the window's 2 span-bit value (offset i at
    bit 2 (span - 1 - i)) and at bits [place, place + 2 width) of the key
    (key base k at bit 2 (n - 1 - k)).  The key is the runs cut out of the
    value and packed together: the OR of ((value >> shift) & (4**width - 1))
    << place."""
    span, n = positions[-1] + 1, len(positions)
    runs, k0 = [], 0
    for k in range(1, n + 1):
        if k == n or positions[k] != positions[k - 1] + 1:
            w = k - k0
            runs.append((2 * (span - positions[k0] - w), w, 2 * (n - k0 - w)))
            k0 = k
    return runs


# The cut table of the rolled spaced window (csrc/kmer_window.cuh Cut): a
# span register and a key register are each at most CUT_WORDS 32-bit words.
# The kernel wrappers check these against the library's own
# (ops/kernels/extract.check_cut_layout) when they load it.
CUT_WORDS = 4
CUT_GROUPS = CUT_WORDS * CUT_WORDS
MAX_ROLLED_SPAN = 64
CUT_TABLE_WORDS = CUT_GROUPS + 1 + 2 * PAIR_BASES + 2


def seed_cut_table(positions) -> list[int]:
    """The launch argument of K1's and K7's rolled spaced window (spans of
    at most MAX_ROLLED_SPAN bases): seed_runs cut into pieces that each lie
    in one 32-bit word of the span register and one of the key, as
    CUT_TABLE_WORDS uint32 words -- group starts, (mask, rot) a piece, the
    64-bit selection mask.  A piece of group g = source word * CUT_WORDS +
    key word ors rotr32(source word, rot) & mask into its key word; the
    selection mask has bit span - 1 - i for each selected offset i (the
    rolled ambiguity bits a window must not hold)."""
    span = positions[-1] + 1
    if span > MAX_ROLLED_SPAN:
        raise ValueError(f"span {span} > {MAX_ROLLED_SPAN}: the window "
                         "gathers its bases instead")
    pieces = []                                   # (group, mask, rot)
    for shift, width, place in seed_runs(positions):
        while width:
            m = min(width, (32 - shift % 32) // 2, (32 - place % 32) // 2)
            pieces.append(((shift // 32) * CUT_WORDS + place // 32,
                           ((1 << 2 * m) - 1) << place % 32,
                           (shift - place) % 32))
            shift, place, width = shift + 2 * m, place + 2 * m, width - m
    pieces.sort(key=lambda p: p[0])
    start = [sum(p[0] < g for p in pieces) for g in range(CUT_GROUPS + 1)]
    pairs = [v for _, mask, rot in pieces for v in (mask, rot)]
    amb = sum(1 << (span - 1 - i) for i in positions)
    return (start + pairs + [0] * (2 * PAIR_BASES - len(pairs))
            + [amb & 0xFFFFFFFF, amb >> 32])


def spaced_lanes(codes: torch.Tensor, lengths: torch.Tensor, mask: str, *,
                 limits: torch.Tensor | None = None, sentinel: bool = True,
                 mask_ambiguous: bool = False, canonical: bool = False):
    """All spaced-seed keys of every read: per window of span len(mask),
    the bases at the mask's '1' offsets (n_bases = the popcount, at most
    63), in the key layout of n_bases.  Don't-care bases are ignored,
    also for ambiguity.  Same contract as kmer_lanes with P = L - span +
    1; canonical needs a palindromic mask."""
    positions = parse_seed_mask(mask)
    check_window(len(positions), positions, canonical)
    return window_keys(codes, lengths, positions, limits=limits,
                       sentinel=sentinel, mask_ambiguous=mask_ambiguous,
                       canonical=canonical)


def gapped_lane_count(L: int, c_min: int, c_max: int) -> int:
    """Lanes per row of the c-major gapped stream: sum over chunk sizes
    c in [c_min, c_max] of the exact offset count max(L - c + 1, 0)."""
    return sum(max(L - c + 1, 0) for c in range(c_min, c_max + 1))


def gapped_lanes(codes: torch.Tensor, lengths: torch.Tensor, l_len: int,
                 r_len: int, c_min: int, c_max: int, *,
                 limits: torch.Tensor | None = None,
                 mask_ambiguous: bool = False):
    """All gapped L+R chunk keys of a batch (reference semantics: for
    every chunk size c and offset o, the l_len bases at o and the r_len
    bases ending at o + c).

    Lanes are c-major with the exact width L - c + 1 per chunk size
    (gapped_lane_count in all).  Lane (c, o) is valid when o + c <=
    lengths[b], o < limits[b] and (mask_ambiguous) neither window holds
    an ambiguous base.  Returns (planes, valid): planes the tuple of
    (B, T) int64 planes of ops/encode.gapped_bases(l_len, r_len) -- hi
    the l-mer value and lo the r-mer value while both are at most 31
    bases, else the words of the string L||R -- SENTINEL_KEY in every
    plane on invalid lanes; valid (B, T) bool.
    """
    if not (l_len >= 1 and r_len >= 1 and c_min >= l_len + r_len):
        raise ValueError("gapped keys need l_len, r_len >= 1 and c_min >= "
                         "l_len + r_len (non-overlapping windows)")
    B, L = codes.shape
    T = gapped_lane_count(L, c_min, c_max)
    dev = codes.device
    bases = gapped_bases(l_len, r_len)
    if T == 0:
        empty = torch.empty((B, 0), dtype=torch.int64, device=dev)
        return (tuple(empty.clone() for _ in bases),
                torch.empty((B, 0), dtype=torch.bool, device=dev))
    c64 = codes.to(torch.int64)
    # ambiguous bases before each position, so that a window's test is a
    # difference of two slices
    amb_cs = torch.nn.functional.pad(torch.cumsum((c64 >= 4).to(torch.int32),
                                                  1), (1, 0))
    c64 = c64 & 3
    tables: dict[int, torch.Tensor] = {}

    def table(m: int) -> torch.Tensor:
        """(B, L - m + 1): the value of the m <= 31 bases at each p."""
        if m not in tables:
            tables[m] = _plane_value([c64[:, j:L - m + 1 + j]
                                      for j in range(m)])
        return tables[m]

    lens = lengths.to(torch.int32)[:, None]
    lims = limits.to(torch.int32)[:, None] if limits is not None else None
    parts, vals = [], []
    for c in range(c_min, min(c_max, L) + 1):
        O_c = L - c + 1
        o = torch.arange(O_c, dtype=torch.int32, device=dev)[None, :]
        v = (o + c) <= lens
        if lims is not None:
            v = v & (o < lims)
        q = c - r_len                        # the R window starts at o + q
        if mask_ambiguous:
            for a, m in ((0, l_len), (q, r_len)):
                v = v & (amb_cs[:, a + m:a + m + O_c]
                         == amb_cs[:, a:a + O_c])

        def segments(t0: int, b: int):
            """(row offset, bases) of the string L||R's bases [t0, t0 +
            b), split where L ends."""
            if t0 + b <= l_len:
                return [(t0, b)]
            if t0 >= l_len:
                return [(q + t0 - l_len, b)]
            return [(t0, l_len - t0), (q, t0 + b - l_len)]

        def value(t0: int, b: int) -> torch.Tensor:
            out = None
            for a, m in segments(t0, b):
                w = table(m)[:, a:a + O_c]
                out = w if out is None else (out << (2 * m)) | w
            return out

        words, t0 = [], 0
        for b in bases:
            if b < 32:
                words.append(value(t0, b))
            else:
                # 32 bases: the first one's high bit is bit 63, stored
                # flipped (as _pack_key)
                (a, _), = segments(t0, 1)
                top = c64[:, a:a + O_c] ^ 2
                w = value(t0 + 1, 31) | ((top & 1) << 62)
                words.append(torch.where(top >= 2, w | LO_FLIP, w))
            t0 += b
        parts.append(words)
        vals.append(v)
    valid = torch.cat(vals, dim=1)
    planes = tuple(torch.where(valid, torch.cat([p[j] for p in parts], 1),
                               SENTINEL_KEY) for j in range(len(bases)))
    return planes, valid
