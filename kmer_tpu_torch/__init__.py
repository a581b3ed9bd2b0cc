"""kmer_tpu_torch: the k-mer counting engine on PyTorch and CUDA.

A port of kmer_tpu to an NVIDIA H100, one slice at a time; kmer_tpu stays
beside it as the reference.  Ported so far: sort-mode counting of
contiguous k-mers, k <= 63, and of spaced seeds (seed_mask), canonical or
not, and of the reference's gapped L+R chunks, with its byte-exact
parity dump; on-device compaction (compact=True); the device-resident
table (device_merge="on"); the unfused count step (KMER_TPU_STEP); dense
mode (k <= 12); the HyperLogLog distinct-k-mer estimate; streaming
two-pass counting with checkpoint/resume (StreamingCounter); and the
saved-table surface: KmerTable's set operations and lookups (merge,
union, intersect, subtract, compare, filter_min_count, get, get_many,
top) behind the CLI's dump, query and tools, the FASTA/FASTQ generators
behind generate, BGZF writing (io/bgzf), and torch.profiler traces and
the roofline model (utils/profiling, count --profile-dir); and multi-GPU
counting (parallel/): a mesh of (data, seq) positions in one process or
over a torch.distributed group, routed (key, count) pairs at exact
sizes, dense tables by all-reduce, count_fasta_multihost, count
--multihost and StreamingCounter(mesh=).  Native
ingest to 2-bit codes, hand-written Hopper kernels (ops/kernels:
fused_extract, extract, grouped_count, fused_gapped, compact, histogram,
sort), and host aggregation into a KmerTable whose keys, TSV and .npz
match kmer_tpu's bit for bit.

    from kmer_tpu_torch import KmerConfig, count_fasta, parity_md5
    table = count_fasta("reads.fasta", k=21, canonical=True, device="cuda")
    same = count_fasta("reads.fasta", k=21, canonical=True,
                       device_merge="on")
    wide = count_fasta("reads.fasta", k=45, canonical=True)
    spaced = count_fasta("reads.fasta", seed_mask="1101011")
    chunks = count_fasta("reads.fasta", KmerConfig(gapped=True))
    assert parity_md5("tests/data/sample.fasta") == SAMPLE_FASTA_MD5
    [(estimate, total)] = estimate_distinct_multi_k("reads.fasta", [21],
                                                    KmerConfig(k=21))
    big = stream_count_fasta("reads.fasta", KmerConfig(k=21),
                             spill_dir="spill")     # rerun to resume
    table.save("a.npz")
    shared = KmerTable.load("a.npz").intersect(KmerTable.load("b.npz"))
    table.get_many(["ACGTACGTACGTACGTACGTA"], canonical=True)

    from kmer_tpu_torch.parallel.mesh import make_mesh
    from kmer_tpu_torch.parallel.multihost import (count_fasta_multihost,
                                                   initialize)
    initialize()                     # under torchrun: join the group
    table = count_fasta_multihost("reads.fasta", KmerConfig(k=21))
    four = count_fasta_multihost("reads.fasta", KmerConfig(k=21),
                                 mesh=make_mesh(4, 1, ["cuda:0"] * 4))
"""

from .config import KmerConfig
from .ops.count import sort_words
from .pipeline.count import count_codes, count_fasta, count_files
from .pipeline.parity import SAMPLE_FASTA_MD5, parity_dump, parity_md5
from .pipeline.sketch import estimate_distinct_files, estimate_distinct_multi_k
from .pipeline.streaming import StreamingCounter, stream_count_fasta
from .pipeline.table import KmerTable

__version__ = "0.5.0"

__all__ = ["KmerConfig", "KmerTable", "count_fasta", "count_files",
           "count_codes", "parity_dump", "parity_md5", "SAMPLE_FASTA_MD5",
           "estimate_distinct_files", "estimate_distinct_multi_k",
           "StreamingCounter", "stream_count_fasta", "sort_words"]
