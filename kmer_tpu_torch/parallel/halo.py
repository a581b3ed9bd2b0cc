"""The halo of reads cut along the seq axis.

Counterpart of kmer_tpu/parallel/halo.py.  When a batch's columns are
split over the seq axis, a window that starts near a shard's right edge
reads the next shard's first bases.  Each shard fetches its halo from
the shards to its right along the seq ring (comm.ring_shift), then owns
exactly the windows that START inside it, so every window is extracted
once (the device-side twin of io.fasta.segment_records' seams).

Batches cross 2-bit packed, 16 bases a word, so packed shards and their
halo are whole words: ceil((span - 1) / 16) of them; u8 rows (skip
invalid) take span - 1 bases.  A halo wider than a shard takes several
hops, whole shards from neighbours 1, 2, ... until it is covered.  The
last shard of a row gets wrapped-around columns: harmless, since a
shard's shifted read lengths (seq_shard_bounds) end every read inside
it.
"""

from __future__ import annotations

import torch

from . import comm
from .mesh import Mesh


def halo_extend(mesh: Mesh, blocks: list[torch.Tensor], halo: int
                ) -> list[torch.Tensor]:
    """Each local position's (B, w) block with the next `halo` columns
    of the following seq shards appended: (B, w + halo)."""
    if halo == 0:
        return blocks
    if mesh.n_seq == 1:
        return [torch.cat([b, b.new_zeros((b.shape[0], halo))], 1)
                for b in blocks]
    parts = [[b] for b in blocks]
    width = blocks[0].shape[1]
    remaining, hop = halo, 1
    while remaining > 0:
        take = min(remaining, width)
        for p, got in zip(parts, comm.ring_shift(mesh, blocks, hop)):
            p.append(got[:, :take])
        remaining -= take
        hop += 1
    out = [torch.cat(p, 1) for p in parts]
    mesh.stats["halo_bytes"] += sum(
        (o.shape[1] - width) * o.shape[0] * o.element_size() for o in out)
    return out


def seq_shard_bounds(lengths: torch.Tensor, limits: torch.Tensor, s: int,
                     shard: int, width: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lengths and limits of seq shard s (shard bases wide, `width`
    with its halo) that make a kernel's local validity test, p <= len -
    span and p < limit, the global one: lengths shifted by the shard's
    first base and clipped to [0, width], limits shifted and clipped to
    [0, shard] (a shard owns only the window starts inside it).  A length
    shorter than the span leaves no window."""
    base = s * shard
    return ((lengths - base).clamp(0, width).to(torch.int32).contiguous(),
            (limits - base).clamp(0, shard).to(torch.int32).contiguous())


def seq_shard_lane_mask(lengths: torch.Tensor, s: int, shard: int,
                        span: int) -> torch.Tensor:
    """(B, shard) validity of seq shard s's window-start lanes: lane p is
    the global start s * shard + p, valid when it fits the read (kmer_tpu's
    seq_shard_lane_mask)."""
    gpos = torch.arange(shard, dtype=torch.int32,
                        device=lengths.device)[None, :] + s * shard
    return gpos <= lengths.to(torch.int32)[:, None] - span
