"""BGZF writer (blocked gzip, the samtools framing), a copy of
kmer_tpu.io.bgzf: the same bytes for the same input.

Every block is an independent gzip member whose FEXTRA 'BC' subfield
carries the compressed block size, which lets the native parser find and
inflate the blocks in parallel (native/fasta_pack.cpp bgzf_index /
bgzf_inflate_all).  Any gzip reader also reads BGZF (concatenated
members).  bgzip and htslib read these files.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

MAX_BLOCK_UDATA = 65280          # bgzip's payload bound per block

_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _one_block(udata: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = c.compress(udata) + c.flush()
    bsize = len(cdata) + 12 + 6 + 8          # header+xtra+cdata+crc+isize
    if bsize - 1 > 0xFFFF:
        raise ValueError("incompressible block exceeds BGZF bound")
    header = struct.pack(
        "<4BIBBHBBHH",
        0x1F, 0x8B, 8, 4,        # magic, deflate, FEXTRA
        0, 0, 0xFF,              # mtime, XFL, OS=unknown
        6,                       # XLEN
        ord("B"), ord("C"), 2,   # BC subfield, SLEN=2
        bsize - 1)
    return header + cdata + struct.pack(
        "<II", zlib.crc32(udata) & 0xFFFFFFFF, len(udata))


def bgzf_compress(data: bytes, block: int = MAX_BLOCK_UDATA) -> bytes:
    """BGZF-compress `data` (at most `block` <= 65280 bytes of payload a
    member), ending with the standard 28-byte EOF marker block.  The
    members are independent and zlib releases the GIL, so they compress
    on a thread a CPU into the same bytes."""
    if not 0 < block <= MAX_BLOCK_UDATA:
        raise ValueError(f"block={block}: 1 to {MAX_BLOCK_UDATA} bytes")
    view = memoryview(data)
    parts = [view[i:i + block] for i in range(0, len(data), block)]
    threads = min(os.cpu_count() or 1, len(parts))
    if threads > 1:
        with ThreadPoolExecutor(threads) as ex:
            out = list(ex.map(_one_block, parts))
    else:
        out = [_one_block(p) for p in parts]
    out.append(_EOF_BLOCK)
    return b"".join(out)


def write_bgzf(path: str, data: bytes | str,
               block: int = MAX_BLOCK_UDATA) -> None:
    if isinstance(data, str):
        data = data.encode()
    with open(path, "wb") as f:
        f.write(bgzf_compress(data, block))
