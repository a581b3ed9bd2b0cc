"""The CUDA kernel K1 against its plain torch version, and the whole
count on the card against the count on the CPU.  Every test here needs a
GPU and skips without one.  This file imports neither jax nor kmer_tpu,
so it also runs on a machine that has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import kmer_tpu_torch
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.io.generator import genome_reads_fasta
from kmer_tpu_torch.ops.kernels import fused_extract as fe

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k,canon,amb,seg,packed",
                         [(21, True, False, 2, True),
                          (21, False, True, 8, False),
                          (16, True, False, 2, True),
                          (31, True, True, 4, False),
                          (5, False, False, 16, True),
                          (1, True, False, 2, True)])
def test_kernel_equals_plain(cuda, k, canon, amb, seg, packed):
    rng = np.random.default_rng(k + seg)
    B, L = 300, 78                    # P = 79 - k: odd and even segments
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = 0                   # zero-length padding rows
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    host = [torch.from_numpy(pack_batch_codes(codes).view(np.int32)
                             if packed else codes),
            torch.from_numpy(lengths), torch.from_numpy(limits)]
    kw = dict(canonical=canon, mask_ambiguous=amb, seg=seg,
              packed_width=L if packed else 0)
    want_keys, want_counts = fe.fused_extract_count(*host, k, **kw)
    before = fe.launches
    keys, counts = fe.fused_extract_count(*(t.to(cuda) for t in host), k,
                                          **kw)
    torch.cuda.synchronize()
    assert fe.launches == before + 1
    assert torch.equal(keys.cpu(), want_keys)
    assert torch.equal(counts.cpu(), want_counts)


def test_wrapper_checks_inputs(cuda):
    codes = torch.zeros((4, 40), dtype=torch.uint8, device=cuda)
    lens = torch.full((4,), 40, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fe.fused_extract_count(codes.t().contiguous().t(), lens, lens, 21)
    with pytest.raises(ValueError, match="lengths"):
        fe.fused_extract_count(codes, lens.cpu(), lens, 21)
    with pytest.raises(ValueError, match="int32"):
        fe.fused_extract_count(codes.to(torch.int32), lens, lens, 21)


def test_count_fasta_cuda_equals_cpu(cuda, tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(genome_reads_fasta(300, 150, genome_len=3000, seed=1,
                                       error_rate=0.01))
    kw = dict(k=21, canonical=True, batch_reads=64, max_read_len=96)
    want = kmer_tpu_torch.count_fasta(str(path), device="cpu", **kw)
    fe.launches = 0
    got = kmer_tpu_torch.count_fasta(str(path), device="cuda", **kw)
    assert got == want and got.total == 300 * 130
    # 150-base reads in 96-base rows: two rows a read, 64 rows a batch
    assert fe.launches == -(-300 * 2 // 64)
