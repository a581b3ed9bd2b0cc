"""The least time the card could take for a layer's work: its bytes over
the card's DRAM bandwidth or its operations over the card's issue rate,
whichever is larger.  One module a layer gives its bytes and operations;
`peaks` holds the card's published rates."""

from __future__ import annotations


def least_seconds(n_bytes: float, n_ops: float, peak: dict) -> float:
    return max(n_bytes / peak["dram_bytes_per_s"],
               n_ops / peak["issue_ops_per_s"])

