"""The plain reference: exact k-mer counts of a FASTA file, in
plain PyTorch on any device, and the comparison that decides `correct`.

It parses the corpus file itself and shares no code with the program
under test.  A k-mer of k <= 62 bases is held as int64 columns, most
significant first: one column, the value sum_j code[j] * 4**(k - 1 - j)
with A=0, C=1, G=2, T=3, up to 31 bases; past that a column of the first
k - 31 bases and one of the last 31.  Canonical keys take the smaller of
a k-mer and its reverse complement.  Tables are sorted and unique.

`narrow=True` is the control: the same counts with every key cut to the
next narrower integer (the low 32 bits of a one-column key; of a
two-column key the low column alone, the high one zero), as a table
that stored keys in half the bits would hold them.
"""

from __future__ import annotations

import numpy as np
import torch

# starting positions of windows computed at a time
BLOCK = 1 << 26
LOW_BASES = 31                  # bases of the low column
MAX_K = 62

_LUT = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i          # lower case


def parse(path: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes (N,) uint8, record (N,) int64) of every base of a FASTA
    file, on `device`.  Raises ValueError on a base other than ACGT."""
    raw = torch.from_numpy(np.fromfile(path, np.uint8)).to(device)
    if raw.numel() == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty.to(torch.uint8), empty
    nl = raw == ord("\n")
    line = torch.cumsum(nl, 0) - nl.long()
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                        torch.nonzero(nl).reshape(-1) + 1])
    starts = starts[starts < raw.numel()]
    head = raw[starts] == ord(">")
    rec_of_line = torch.cumsum(head, 0) - 1
    keep = ~head[line] & ~nl & (raw != ord("\r"))
    codes = torch.from_numpy(_LUT).to(device)[raw[keep].long()]
    if codes.numel() and int(codes.max()) > 3:
        raise ValueError(f"{path}: a base other than ACGT")
    return codes, rec_of_line[line][keep]


def _forward(c: torch.Tensor, off: int, m: int, n: int) -> torch.Tensor:
    """Value of the m bases at off + i, first base most significant, for
    each start i < n."""
    v = torch.zeros(n, dtype=torch.int64, device=c.device)
    for j in range(m):
        v = v * 4 + c[off + j:off + j + n]
    return v


def _reverse(c: torch.Tensor, off: int, m: int, n: int) -> torch.Tensor:
    """Value of the complement of the m bases at off + i, first base
    least significant: the reverse complement's value."""
    v = torch.zeros(n, dtype=torch.int64, device=c.device)
    for j in range(m):
        v = v + ((3 - c[off + j:off + j + n]) << (2 * j))
    return v


def lexsort(cols: list[torch.Tensor]) -> torch.Tensor:
    """The permutation sorting rows by cols, the first most
    significant."""
    perm = torch.arange(cols[0].numel(), device=cols[0].device)
    for col in reversed(cols):
        perm = perm[torch.sort(col[perm], stable=True).indices]
    return perm


def _reduce(cols, counts):
    """Sorted unique rows of cols with their counts summed."""
    if counts.numel() == 0:
        return cols, counts
    perm = lexsort(cols)
    cols = [c[perm] for c in cols]
    counts = counts[perm]
    start = torch.ones(counts.numel(), dtype=torch.bool, device=counts.device)
    for c in cols:
        start[1:] &= c[1:] == c[:-1]
    start = ~start
    start[0] = True
    run = torch.cumsum(start, 0) - 1
    totals = torch.zeros(int(run[-1]) + 1, dtype=torch.int64,
                         device=counts.device).index_add_(0, run, counts)
    return [c[start] for c in cols], totals


def _window_keys(codes, rec, s: int, n: int, k: int, canonical: bool,
                 narrow: bool) -> list[torch.Tensor]:
    """Key columns of the n windows starting at s, s + 1, ..., those that
    cross a record's end left out."""
    c = codes[s:s + n + k - 1].long()
    valid = rec[s:s + n] == rec[s + k - 1:s + n + k - 1]
    if k <= LOW_BASES:
        key = _forward(c, 0, k, n)
        if canonical:
            key = torch.minimum(key, _reverse(c, 0, k, n))
        cols = [key & 0xFFFFFFFF] if narrow else [key]
    else:
        h = k - LOW_BASES
        hi, lo = _forward(c, 0, h, n), _forward(c, h, LOW_BASES, n)
        if canonical:
            rhi, rlo = _reverse(c, LOW_BASES, h, n), _reverse(c, 0,
                                                             LOW_BASES, n)
            take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
            hi, lo = torch.where(take, rhi, hi), torch.where(take, rlo, lo)
        cols = [torch.zeros_like(lo), lo] if narrow else [hi, lo]
    return [col[valid] for col in cols]


def count_kmers(path: str, k: int, canonical: bool, device,
                narrow: bool = False):
    """(key columns, counts (M,) int64) of every k-mer of the file,
    sorted and unique; windows never cross a record's end."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the reference counts k of 1 to {MAX_K}, not {k}")
    codes, rec = parse(path, device)
    starts = codes.numel() - k + 1
    parts = []
    for s in range(0, max(starts, 0), BLOCK):
        cols = _window_keys(codes, rec, s, min(BLOCK, starts - s), k,
                            canonical, narrow)
        parts.append(_reduce(cols, torch.ones_like(cols[0])))
    del codes, rec
    if not parts:
        n_cols = 1 if k <= LOW_BASES else 2
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return [empty] * n_cols, empty
    if len(parts) == 1:
        return parts[0]
    return _reduce([torch.cat(c) for c in zip(*(p[0] for p in parts))],
                   torch.cat([p[1] for p in parts]))


def words_to_cols(words: np.ndarray, k: int) -> list[np.ndarray]:
    """A table's (M, W) uint32 key words, most significant first and the
    value in the low 2k bits, as the reference's int64 columns."""
    words = np.asarray(words, np.uint32)
    if words.ndim != 2 or words.shape[1] > 4:
        raise ValueError(f"key words of shape {words.shape}")
    w = np.zeros((len(words), 4), np.uint64)
    w[:, 4 - words.shape[1]:] = words
    top = (w[:, 0] << np.uint64(32)) | w[:, 1]          # bits 64 .. 127
    low = (w[:, 2] << np.uint64(32)) | w[:, 3]          # bits 0 .. 63
    lo = low & np.uint64((1 << 2 * LOW_BASES) - 1)
    if k <= LOW_BASES:
        return [lo.view(np.int64)]
    hi = (top << np.uint64(2)) | (low >> np.uint64(2 * LOW_BASES))
    return [hi.view(np.int64), lo.view(np.int64)]


def mismatched_rows(got_cols, got_counts, want_cols, want_counts) -> int:
    """Rows of `got` (key columns and counts) that are not rows of the
    sorted unique `want`, plus rows of `want` not in `got`, plus rows of
    `got` out of strictly increasing key order.  0 means the same
    table."""
    n = got_counts.numel()
    unsorted = 0
    if n > 1:
        lt = torch.zeros(n - 1, dtype=torch.bool, device=got_counts.device)
        eq = torch.ones(n - 1, dtype=torch.bool, device=got_counts.device)
        for c in got_cols:
            lt |= eq & (c[:-1] < c[1:])
            eq &= c[:-1] == c[1:]
        unsorted = int((~lt).sum())
    side = torch.cat([torch.zeros(n, dtype=torch.int64,
                                  device=got_counts.device),
                      torch.ones(want_counts.numel(), dtype=torch.int64,
                                 device=got_counts.device)])
    cols = [torch.cat([g, w]) for g, w in zip([*got_cols, got_counts],
                                               [*want_cols, want_counts])]
    perm = lexsort(cols + [side])
    cols, side = [c[perm] for c in cols], side[perm]
    same = side[:-1] < side[1:]
    for c in cols:
        same &= c[:-1] == c[1:]
    matched = int(same.sum())
    return n + want_counts.numel() - 2 * matched + unsorted
