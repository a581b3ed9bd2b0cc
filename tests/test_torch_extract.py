"""Kernel K7's plain version (ops/kernels/extract, row-layout extraction
with no collapse) against kmer_tpu: lane for lane against the Pallas K7,
extract_repacked in interpret mode, through words_to_tpu_repacked, and
against kmer_tpu's kmer_lanes / canonical_kmer_lanes where the Pallas
kernel does not reach (k < 17, ambiguous codes).  Inputs come from
np.random.default_rng; every comparison is exact.  The CUDA kernel is
held against the plain version in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops.canonical import canonical_kmer_lanes as jax_canonical
from kmer_tpu.ops.extract import kmer_lanes as jax_kmer_lanes
from kmer_tpu.ops.pallas.extract import extract_repacked
from kmer_tpu_torch.io.fasta import pack_batch_codes
from kmer_tpu_torch.ops.encode import (SENTINEL_KEY, keys_u32_to_i64,
                                       words_from_tpu_repacked,
                                       words_to_tpu_repacked)
from kmer_tpu_torch.ops.kernels import extract as ek


def _batch(seed, B, L, *, amb=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:2] = L                   # some full rows
    limits = rng.integers(1, L + 1, B).astype(np.int32)
    limits[:2] = L
    return codes, lengths, limits


def _port(codes, lengths, limits, k, **kw):
    return ek.extract_keys(torch.from_numpy(codes), torch.from_numpy(lengths),
                           torch.from_numpy(limits), k, **kw).numpy()


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [17, 21, 25, 31])
def test_plain_equals_pallas_extract(k, canonical):
    codes, lengths, limits = _batch(3 * k + canonical, 40, 80)
    top, bot = extract_repacked(jnp.asarray(codes), jnp.asarray(lengths),
                                jnp.asarray(limits), k, canonical,
                                interpret=True)
    keys = _port(codes, lengths, limits, k, canonical=canonical)
    assert keys.shape == (40, 80 - k + 1)
    rtop, rbot = words_to_tpu_repacked(keys, k)
    np.testing.assert_array_equal(rtop, np.asarray(top))
    np.testing.assert_array_equal(rbot, np.asarray(bot))
    # and back: the Pallas kernel's words are the port's keys
    np.testing.assert_array_equal(
        words_from_tpu_repacked([np.asarray(top), np.asarray(bot)], k), keys)
    assert (keys != SENTINEL_KEY).any() and (keys == SENTINEL_KEY).any()


@pytest.mark.parametrize("amb", [False, True])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [1, 5, 11, 15, 16, 21, 31])
def test_plain_equals_kmer_lanes(k, canonical, amb):
    """Every k <= 31, with the skip-invalid ambiguity mask."""
    codes, lengths, limits = _batch(100 + 7 * k + 2 * canonical + amb, 33,
                                    70, amb=amb)
    fn = jax_canonical if canonical else jax_kmer_lanes
    words, _ = fn(jnp.asarray(codes), jnp.asarray(lengths), k,
                  limits=jnp.asarray(limits), mask_ambiguous=amb)
    want = keys_u32_to_i64(
        np.stack([np.asarray(w).reshape(-1) for w in words], 1), k)
    keys = _port(codes, lengths, limits, k, canonical=canonical,
                 mask_ambiguous=amb)
    np.testing.assert_array_equal(keys.reshape(-1), want)


@pytest.mark.parametrize("k,canonical", [(21, True), (9, False), (31, True)])
def test_packed_rows_equal_u8_rows(k, canonical):
    codes, lengths, limits = _batch(k, 50, 77)
    packed = pack_batch_codes(codes).view(np.int32)
    np.testing.assert_array_equal(
        _port(packed, lengths, limits, k, canonical=canonical,
              packed_width=77),
        _port(codes, lengths, limits, k, canonical=canonical))


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_repacked_round_trip(k):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), (6, 50))
    keys[rng.random((6, 50)) < 0.2] = SENTINEL_KEY
    rw = words_to_tpu_repacked(keys, k)
    assert all(w.dtype == np.uint32 and w.shape == keys.shape for w in rw)
    np.testing.assert_array_equal(words_from_tpu_repacked(rw, k), keys)


def test_extract_rejects_bad_inputs():
    codes = torch.zeros((4, 40), dtype=torch.uint8)
    lens = torch.full((4,), 40, dtype=torch.int32)
    with pytest.raises(ValueError, match="row width"):
        ek.extract_keys(codes, lens, lens, 64)      # k = 64 is taken now
    assert len(ek.extract_keys(codes, lens, lens, 40)) == 2
    with pytest.raises(ValueError, match="row width"):
        ek.extract_keys(codes[:, :10], lens, lens, 21)
    with pytest.raises(ValueError, match="packed rows"):
        ek.extract_keys(codes.to(torch.int32), lens, lens, 21,
                        packed_width=40)
    with pytest.raises(ValueError, match="meta"):
        ek.extract_keys(codes.to("meta"), lens, lens, 21)
    before = ek.launches
    ek.extract_keys(codes, lens, lens, 21)
    assert ek.launches == before      # the plain version launches nothing
