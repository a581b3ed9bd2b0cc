"""Kernel K1 (the fused count step).  Its plain torch version must equal
kmer_tpu's Pallas kernel (run in interpret mode on the CPU, as kmer_tpu's
own tests run it) lane for lane: keys and in-segment counts, exactly.
The CUDA kernel is held against the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.io.fasta import pack_batch_codes
from kmer_tpu.ops import count as C
from kmer_tpu.ops.canonical import canonical_kmer_lanes
from kmer_tpu.ops.extract import kmer_lanes
from kmer_tpu.ops.pallas.fused_extract import fused_extract_count_T
from kmer_tpu.pipeline.table import KmerTable as JaxTable
from kmer_tpu_torch.ops.encode import keys_i64_to_u32
from kmer_tpu_torch.ops.kernels import fused_extract as fe
from kmer_tpu_torch.pipeline.table import KmerTable


def _batch(seed, B, L, amb):
    """Random codes (code 4 = ambiguous when amb), random short lengths
    (zero-length padding rows included) and ownership limits."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B, dtype=np.int32)
    lengths[:2] = 0
    lengths[2] = L
    limits = rng.integers(1, L + 1, B, dtype=np.int32)
    return codes, lengths, limits


def _torch_args(codes, lengths, limits, packed):
    if packed:
        c = torch.from_numpy(pack_batch_codes(codes).view(np.int32))
    else:
        c = torch.from_numpy(codes)
    return c, torch.from_numpy(lengths), torch.from_numpy(limits)


@pytest.mark.parametrize("seg", [2, 8])
@pytest.mark.parametrize("k,canon,amb", [(21, True, False),
                                         (21, False, True),
                                         (17, True, True),
                                         (31, False, False),
                                         (11, True, False)])
def test_plain_k1_equals_pallas_k1_lane_for_lane(k, canon, amb, seg):
    B, L = 24, 61                        # odd P: the last segment is padded
    codes, lengths, limits = _batch(5 * k + 2 * canon + amb + seg, B, L, amb)
    rflat, jcounts = fused_extract_count_T(
        jnp.asarray(codes).T, jnp.asarray(lengths), jnp.asarray(limits), k,
        canonical=canon, mask_ambiguous=amb, seg=seg, block_lanes=128,
        algo="dedup", interpret=True)
    P_pad = -(-(L - k + 1) // seg) * seg
    want_words = np.stack(
        [np.asarray(w).reshape(P_pad, -1)[:, :B].reshape(-1)
         for w in C.unpack_words(rflat, k)], axis=1)
    want_counts = np.asarray(jcounts).reshape(P_pad, -1)[:, :B]

    keys, counts = fe.fused_extract_count(
        *_torch_args(codes, lengths, limits, False), k, canonical=canon,
        mask_ambiguous=amb, seg=seg)
    assert keys.shape == (P_pad, B) and keys.dtype == torch.int64
    assert counts.shape == (P_pad, B) and counts.dtype == torch.int8
    np.testing.assert_array_equal(
        keys_i64_to_u32(keys.numpy().reshape(-1), k), want_words)
    np.testing.assert_array_equal(counts.numpy(), want_counts.astype(np.int8))
    if not amb:
        # the 2-bit packed rows give the same lanes as the u8 rows
        pk, pc = fe.fused_extract_count(
            *_torch_args(codes, lengths, limits, True), k, canonical=canon,
            seg=seg, packed_width=L)
        assert torch.equal(pk, keys) and torch.equal(pc, counts)


@pytest.mark.parametrize("canon", [True, False])
def test_k16_tables_match_reference_extraction(canon):
    """k=16 fills all 32 bits of a word (W=2 with an empty top word),
    which kmer_tpu's fused kernel does not take on its default
    extractors: compare as aggregated tables against kmer_lanes /
    canonical_kmer_lanes."""
    k, B, L = 16, 24, 60
    codes, lengths, limits = _batch(16 + canon, B, L, amb=False)
    keys, counts = fe.fused_extract_count(
        *_torch_args(codes, lengths, limits, True), k, canonical=canon,
        seg=2, packed_width=L)
    got = KmerTable.from_device_runs(k, keys.numpy(), counts.numpy())

    fn = canonical_kmer_lanes if canon else kmer_lanes
    words, valid = fn(jnp.asarray(codes), jnp.asarray(lengths), k,
                      limits=jnp.asarray(limits))
    ks = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    v = np.asarray(valid).reshape(-1)
    want = JaxTable.from_pairs(k, ks[v], np.ones(int(v.sum()), np.int64))
    assert got.total == int(v.sum())
    assert got == want


def test_segment_counts_sit_on_first_occurrence():
    """A read of one repeated base: every window is the same key, so each
    segment holds one count of `seg` on its first lane (and the odd tail
    segment of P is cut by validity)."""
    k, L, seg = 5, 12, 4                      # P = 8 = two segments
    codes = torch.zeros((1, L), dtype=torch.uint8)
    lengths = torch.tensor([L - 1], dtype=torch.int32)   # P valid = 7
    limits = torch.tensor([L], dtype=torch.int32)
    keys, counts = fe.fused_extract_count(codes, lengths, limits, k, seg=seg)
    assert counts[:, 0].tolist() == [4, 0, 0, 0, 3, 0, 0, 0]
    assert keys[7, 0] == fe.SENTINEL_KEY


def test_wrapper_refuses_other_devices():
    codes = torch.zeros((2, 30), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fe.fused_extract_count(codes, lens, lens, 21)
