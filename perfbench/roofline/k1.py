"""K1, the fused count step (`csrc/fused_extract.cu`), one launch over a
batch of B rows of width L: each row's codes read once (2-bit packed,
ceil(L / 16) int32 words, or one byte a base), its length and limit (two
int32), and P_pad output lanes a row written once, W int64 key words and
an int8 count each; about 16 integer operations a lane (the key and its
reverse complement, the minimum, validity, the collapse)."""

from __future__ import annotations


def n_bytes(B: int, L: int, P_pad: int, W: int, packed: bool) -> int:
    row = -(-L // 16) * 4 if packed else L
    return B * row + 8 * B + P_pad * B * (8 * W + 1)


def n_ops(B: int, P_pad: int) -> int:
    return 16 * P_pad * B
