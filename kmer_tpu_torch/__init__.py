"""kmer_tpu_torch: the k-mer counting engine on PyTorch and CUDA.

A port of kmer_tpu to an NVIDIA H100, one slice at a time; kmer_tpu stays
beside it as the reference.  This slice is sort-mode counting of
contiguous k-mers, k <= 31, canonical or not: native ingest to 2-bit
codes, one hand-written Hopper kernel per batch
(ops/kernels/fused_extract), and host aggregation into a KmerTable whose
keys, TSV and .npz match kmer_tpu's bit for bit.

    from kmer_tpu_torch import count_fasta
    table = count_fasta("reads.fasta", k=21, canonical=True, device="cuda")
"""

from .config import KmerConfig
from .pipeline.count import count_codes, count_fasta, count_files
from .pipeline.table import KmerTable

__version__ = "0.5.0"

__all__ = ["KmerConfig", "KmerTable", "count_fasta", "count_files",
           "count_codes"]
