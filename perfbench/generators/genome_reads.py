"""Reads sampled from one seeded random genome, written as FASTA.

The traffic file's `params` say what to draw:

- `genome_len`: bases of the genome, drawn uniformly from ACGT;
- `n_reads`: reads in the corpus;
- `read_len`: one length for every read, or `[lo, hi]` for lengths drawn
  uniformly from lo to hi inclusive;
- `error_rate`: the chance that a base is replaced by one of the other
  three (substitutions only);
- `revcomp_share`: the chance that a read is written as its reverse
  complement.

Each read starts at a uniform position on the genome.  Headers are ">r"
and a 10-digit read number; sequences are on one line.  The draws run on
`device` from a torch.Generator seeded with the seed, a slice of reads
at a time, and the bytes are written as each slice is done: the same
seed on the same kind of device gives the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

# bases drawn and written at a time
SLICE_BASES = 1 << 26
HEAD = 13                      # ">r", 10 digits, "\n"
ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def generator_for(seed: int, device) -> torch.Generator:
    """The generator of a seed: any whole number, negative or past 64
    bits included."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 64))


def _lengths(gen, n: int, read_len, device) -> torch.Tensor:
    if isinstance(read_len, int):
        return torch.full((n,), read_len, dtype=torch.int64, device=device)
    lo, hi = read_len
    return torch.randint(lo, hi + 1, (n,), generator=gen, device=device)


def _records(gen, genome: torch.Tensor, first: int, lens: torch.Tensor,
             error_rate: float, revcomp_share: float) -> torch.Tensor:
    """The bytes of reads first .. first + len(lens) - 1, as uint8."""
    dev = genome.device
    n, total = lens.numel(), int(lens.sum())
    span = genome.numel() - lens + 1
    starts = (torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
              * span).long().clamp_(max=span - 1)
    read_of = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offs[1:])
    idx = torch.arange(total, device=dev)
    pos = idx - offs[read_of]
    codes = genome[starts[read_of] + pos]
    hit = torch.rand(total, generator=gen, device=dev) < error_rate
    shift = torch.randint(1, 4, (total,), generator=gen, device=dev,
                          dtype=torch.uint8)
    codes = torch.where(hit, (codes + shift) % 4, codes)
    flip = (torch.rand(n, generator=gen, device=dev) < revcomp_share)[read_of]
    codes = codes[torch.where(flip, offs[read_of + 1] - 1 - pos, idx)]
    codes = torch.where(flip, 3 - codes, codes)

    rec_len = HEAD + lens + 1                       # header, sequence, "\n"
    rec_off = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(rec_len, 0, out=rec_off[1:])
    out = torch.empty(int(rec_off[-1]), dtype=torch.uint8, device=dev)
    base = rec_off[:-1]
    out[base] = ord(">")
    out[base + 1] = ord("r")
    num = torch.arange(first, first + n, device=dev)
    for j in range(10):
        out[base + 11 - j] = (48 + (num // 10 ** j) % 10).to(torch.uint8)
    out[base + 12] = ord("\n")
    seq_at = base[read_of] + HEAD + pos
    out[seq_at] = ASCII.to(dev)[codes.long()]
    out[base + HEAD + lens] = ord("\n")
    return out


def write(path: str, params: dict, seed: int, device="cpu") -> np.ndarray:
    """Write the corpus of `params` drawn from `seed` on `device` to
    `path`; returns every read's length, in file order."""
    gen = generator_for(seed, device)
    genome = torch.randint(0, 4, (int(params["genome_len"]),), generator=gen,
                           device=device, dtype=torch.uint8)
    n_reads = int(params["n_reads"])
    read_len = params["read_len"]
    mean = read_len if isinstance(read_len, int) else sum(read_len) / 2
    slice_reads = max(1, int(SLICE_BASES // mean))
    lengths = []
    with open(path, "wb") as f:
        for first in range(0, n_reads, slice_reads):
            lens = _lengths(gen, min(slice_reads, n_reads - first), read_len,
                            device)
            f.write(_records(gen, genome, first, lens,
                             float(params["error_rate"]),
                             float(params.get("revcomp_share", 0.5))
                             ).cpu().numpy().tobytes())
            lengths.append(lens.cpu().numpy())
    return np.concatenate(lengths)
