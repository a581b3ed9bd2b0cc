"""Device-resident sorted-table accumulation ("device merge").

Counterpart of kmer_tpu/ops/devmerge.py.  The sort-mode table stays on
the device between batches as W int64 key words (one key of up to 31
bases, or a (hi, lo) pair: gapped, or a key of 32 to 63 bases) plus
int64 counts, sorted and unique,
padded with SENTINEL rows (count 0) that sort after every real key.
Each group of batches merges into it with one stable sort of the key
words, the counts riding along as payload, as kmer_tpu's lax.sort with
num_keys = W (kernel K6 on a GPU, through ops/count.sort_words), then
the run totals and the compaction of the run starts to the front
(ops/kernels/merge_reduce): on a GPU one kernel, a single pass with
decoupled look-back (csrc/merge_reduce.cu); on the CPU its plain twin,
kmer_tpu's form, run totals by cumsum and a backward cummin and a
scatter.  The host reads the distinct rows once, at a drain.

Capacity contract: merge_batch never drops a key as long as C >= distinct
+ N (C the state's rows, N the batch's lanes).  pipeline/count's
DeviceMerge keeps it by growing the state (grow_state, a sentinel
append) within max_rows, draining and resetting past it.  merge_batch
itself raises when N > C, which no drain could cure.

Counts are int64 end to end, so no total can overflow and no drain is
needed for the counts' sake (kmer_tpu's int32 counts needed one before
2**31).

The drain (fetch_state_wire) reads the table in narrow tiers, as
kmer_tpu's: key deltas in three u8 planes (u24) or one u32 plane, with u8
counts and a fixed-size escape patch, for keys whose value fits one int64
(at most 31 bases); the raw key words and u8 counts for wider pairs.  It
returns exactly what fetch_state returns.  Under the caller's
`readback` stage (utils/stagetime) the reads time their parts:
`readback.encode` (the wire encode's launches and the reads of its sizes,
which wait for the device), `readback.copy` (every copy to the host) and
`readback.decode` (the host's rebuild of the rows).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import stagetime
from .count import sort_words
from .kernels.merge_reduce import merge_reduce
from .kernels.sort import SENTINEL

WIRE_PATCH_ROWS = 65536


def empty_state(capacity: int, n_words: int, device="cpu"):
    """Fresh state: `n_words` all-sentinel key planes and zero counts,
    `capacity` rows each, on `device`."""
    words = [torch.full((capacity,), SENTINEL, dtype=torch.int64,
                        device=device) for _ in range(n_words)]
    return words, torch.zeros(capacity, dtype=torch.int64, device=device)


def merge_batch(state_words, state_counts, batch_words, batch_counts,
                bits=None):
    """Merge one batch's lanes (duplicates allowed; count <= 0 marks a
    dead lane) into the sorted unique state.

    state_words: W (C,) int64 planes, sorted unique, sentinel-padded;
    state_counts: (C,) int64.  batch_words: W int64 tensors of N lanes
    (any shape); batch_counts: N lanes of any integer dtype.  bits: the
    key words' value bits (sort_words' promise; default 64).  Returns
    (words, counts, distinct): the new state, C rows, and its live row
    count as a device scalar, without a host sync.  Requires C >=
    distinct_before + N; raises when N > C."""
    with stagetime.span("op::merge_batch"):
        return _merge_batch(state_words, state_counts, batch_words,
                            batch_counts, bits)


def _merge_batch(state_words, state_counts, batch_words, batch_counts,
                 bits):
    W = len(state_words)
    C = state_counts.numel()
    bc = batch_counts.reshape(-1).to(torch.int64)
    if bc.numel() > C:
        raise ValueError(f"a merge of {bc.numel()} lanes into a {C}-row "
                         "state would drop keys; grow the state first")
    dead = bc <= 0
    bw = [torch.where(dead, SENTINEL, w.reshape(-1)) for w in batch_words]
    ops = ([torch.cat([s, b]) for s, b in zip(state_words, bw)]
           + [torch.cat([state_counts, bc.clamp(min=0)])])
    *kw, counts = sort_words(ops, num_keys=W, bits=bits)
    with stagetime.span("op::merge_reduce"):
        return merge_reduce(kw, counts, C)


def grow_state(state_words, state_counts, new_rows: int):
    """The state with sentinel rows appended up to `new_rows` (no sort:
    sentinel rows already sort last); as it is when new_rows <= C."""
    C = state_counts.numel()
    if new_rows <= C:
        return state_words, state_counts
    pad = torch.full((new_rows - C,), SENTINEL, dtype=torch.int64,
                     device=state_counts.device)
    words = [torch.cat([w, pad]) for w in state_words]
    counts = torch.cat([state_counts, torch.zeros_like(pad)])
    return words, counts


def max_rows(n_words: int) -> int:
    """Growth budget in rows, a power of two >= 2**16: the state may
    take KMER_TPU_DEVMERGE_MAX_MB (default 1024) of device memory at
    8 * (W + 1) bytes a row; past it DeviceMerge drains and resets.

    The budget bounds the state alone.  A merge also holds the pending
    group (up to C / 2 lanes of step output), the concatenation of state
    and group and the sort's buffers, so the card's peak is several times
    the state (chip_smoke.py prints both for every device-merge run)."""
    try:
        mb = float(os.environ.get("KMER_TPU_DEVMERGE_MAX_MB", "1024"))
    except ValueError:
        mb = 1024.0
    r = max(1, int(mb * 1e6) // (8 * (n_words + 1)))
    return max(1 << 16, 1 << (r.bit_length() - 1))


def fetch_state(state_words, state_counts, distinct: int):
    """The live rows on the host: (keys (d, W) int64, counts (d,)
    int64)."""
    d = int(distinct)
    with stagetime.stage("readback.copy"):
        words = [w[:d].cpu().numpy() for w in state_words]
        counts = state_counts[:d].cpu().numpy()
    with stagetime.stage("readback.decode"):
        keys = np.stack(words, axis=1)
    return keys.reshape(d, len(state_words)), counts


# ---------------------------------------------------------------------------
# Wire-compressed drain.  A table of d distinct keys over a 2**b keyspace
# has a mean key gap of 2**b / d, and counts almost always fit 8 bits:
#   u24 -- three u8 delta planes + u8 counts (4 B a row);
#   u32 -- one 32-bit delta plane + u8 counts (5 B a row), when too many
#          gaps pass 2**24;
#   c8  -- raw key words + u8 counts (8 W + 1 B a row), for keys wider
#          than one int64 value;
# against 8 (W + 1) B a row raw.  A fixed-size escape patch carries the
# full (row, delta, count) of every row whose delta or count does not fit
# (the first row's delta is its key).  fetch_state_wire takes the
# narrowest tier whose patch fits and returns None when none does.

def _key_values(state_words, state_counts, rows: int, shift: int):
    """(values, counts, live) of the first `rows` rows: the key (W = 1),
    or hi << shift | lo (a pair whose value fits 62 bits); 0 on dead
    rows."""
    c = state_counts[:rows]
    live = c > 0
    v = torch.where(live, state_words[0][:rows], 0)
    if len(state_words) == 2:
        v = torch.where(live, (v << shift) | state_words[1][:rows], 0)
    return v, c, live


def _wire_deltas(state_words, state_counts, rows: int, shift: int):
    v, c, live = _key_values(state_words, state_counts, rows, shift)
    return v - torch.cat([v.new_zeros(1), v[:-1]]), c, live


def _wire_patch(esc, cols):
    """(P, 1 + len(cols)) int64: (row, *cols) of the escaped rows in row
    order, compacted to the front; row -1 past the escapes.  Scattered
    through cumsum(esc), as merge_reduce_ref compacts, with no host sync."""
    P = WIRE_PATCH_ROWS
    dest = torch.where(esc, torch.cumsum(esc, 0) - 1, P).clamp_(max=P)
    idx = torch.arange(esc.numel(), dtype=torch.int64, device=esc.device)
    out = [torch.full((P + 1,), -1 if j == 0 else 0, dtype=torch.int64,
                      device=esc.device).scatter_(0, dest, x)[:P]
           for j, x in enumerate([idx, *cols])]
    return torch.stack(out, 1)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return (x & 0xFF).to(torch.uint8)


def wire_encode(state_words, state_counts, rows: int, shift: int = 0):
    """u24 encode of the first `rows` rows (keys of at most 31 bases):
    (d0, d1, d2 (rows,) u8 delta bytes, low first, count8 (rows,) u8,
    patch (P, 3) int64 of (row, delta, count), n_escapes_u24,
    n_escapes_u32).  The second count lets the host pick the u32 tier
    without another pass.  Dead rows (count 0) never escape."""
    dl, c, live = _wire_deltas(state_words, state_counts, rows, shift)
    esc32 = live & ((dl >= 1 << 32) | (c > 255))
    esc = esc32 | (live & (dl >= 1 << 24))
    return (_u8(dl), _u8(dl >> 8), _u8(dl >> 16),
            c.clamp(max=255).to(torch.uint8), _wire_patch(esc, [dl, c]),
            esc.sum(), esc32.sum())


def wire_encode32(state_words, state_counts, rows: int, shift: int = 0):
    """u32 encode (sparser tables): (delta (rows,) int32 holding the
    delta's low 32 bits, count8 (rows,) u8, patch (P, 3) int64,
    n_escapes); escapes only for deltas >= 2**32 or counts > 255."""
    dl, c, live = _wire_deltas(state_words, state_counts, rows, shift)
    esc = live & ((dl >= 1 << 32) | (c > 255))
    low = (((dl + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    return (low, c.clamp(max=255).to(torch.uint8), _wire_patch(esc, [dl, c]),
            esc.sum())


def wire_encode_c8(state_counts, rows: int):
    """Count-only encode for keys wider than one int64 value: (count8
    (rows,) u8, patch (P, 2) int64 of (row, count), n_escapes)."""
    c = state_counts[:rows]
    esc = c > 255
    return c.clamp(max=255).to(torch.uint8), _wire_patch(esc, [c]), esc.sum()


def _apply_patch(dl: np.ndarray, counts: np.ndarray, p: np.ndarray,
                 d: int) -> None:
    """Overwrite the escaped rows' deltas and counts from the patch's
    escaped rows `p` (on the host)."""
    p = p[p[:, 0] < d]
    dl[p[:, 0]] = p[:, 1]
    counts[p[:, 0]] = p[:, 2]


def _fetch_wide_c8(state_words, state_counts, d: int):
    with stagetime.stage("readback.encode"):
        cnt8, patch, n_esc = wire_encode_c8(state_counts, d)
        n_esc = int(n_esc)
    if n_esc > WIRE_PATCH_ROWS:
        return None
    with stagetime.stage("readback.copy"):
        cnt8 = cnt8.cpu().numpy()
        p = patch[:n_esc].cpu().numpy() if n_esc else None
        words = [w[:d].cpu().numpy() for w in state_words]
    with stagetime.stage("readback.decode"):
        counts = cnt8.astype(np.int64)
        if n_esc:
            counts[p[:, 0]] = p[:, 1]
        keys = np.stack(words, axis=1)
    return keys, counts


def fetch_state_wire(state_words, state_counts, distinct: int, *,
                     l_len: int = 0, r_len: int = 0):
    """fetch_state through the narrowest wire tier that fits, or None
    when every tier's escape patch overflows (the caller then takes
    fetch_state).  A two-word state is a (hi, lo) pair of l_len + r_len
    bases (a key of 32 to 63 bases is the pair at l_len = 31): deltas of
    its value when that is at most 31 bases, else the raw words."""
    d = int(distinct)
    W = len(state_words)
    if d == 0:
        return fetch_state(state_words, state_counts, 0)
    if W > 2 or (W == 2 and l_len + r_len > 31):
        return _fetch_wide_c8(state_words, state_counts, d)
    shift = 2 * r_len if W == 2 else 0
    with stagetime.stage("readback.encode"):
        d0, d1, d2, cnt8, patch, n24, n32 = wire_encode(
            state_words, state_counts, d, shift)
        n24 = int(n24)
        if n24 <= WIRE_PATCH_ROWS:
            planes, n_esc = (d0, d1, d2), n24
        elif int(n32) <= WIRE_PATCH_ROWS:
            low, cnt8, patch, n_esc = wire_encode32(state_words,
                                                    state_counts, d, shift)
            planes, n_esc = (low,), int(n_esc)
        else:
            return None
    with stagetime.stage("readback.copy"):
        planes = [t.cpu().numpy() for t in planes]
        cnt8 = cnt8.cpu().numpy()
        p = patch[:n_esc].cpu().numpy() if n_esc else None
    with stagetime.stage("readback.decode"):
        if len(planes) == 3:
            d0, d1, d2 = planes
            dl = (d0.astype(np.int64) | d1.astype(np.int64) << 8
                  | d2.astype(np.int64) << 16)
        else:
            dl = planes[0].view(np.uint32).astype(np.int64)
        counts = cnt8.astype(np.int64)
        if n_esc:
            _apply_patch(dl, counts, p, d)
        values = np.cumsum(dl)
        if W == 1:
            return values.reshape(-1, 1), counts
        return np.stack([values >> shift, values & ((1 << shift) - 1)],
                        axis=1), counts
