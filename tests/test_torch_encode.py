"""kmer_tpu_torch.ops.encode against kmer_tpu.ops.encode: the int64 key
layout converts exactly to and from the (M, W) uint32 word layout, and
the device unpack inverts the host 2-bit packer.  All comparisons are
exact (integer keys: tolerance zero)."""

import numpy as np
import pytest
import torch

from kmer_tpu.io.fasta import pack_batch_codes
from kmer_tpu.ops import encode as jenc
from kmer_tpu_torch import KmerConfig
from kmer_tpu_torch.ops import encode as tenc


def _values(codes: np.ndarray) -> np.ndarray:
    """Independent int64 key values: sum code[j] * 4**(k-1-j)."""
    k = codes.shape[1]
    return np.array([sum(int(c) << (2 * (k - 1 - j)) for j, c in
                         enumerate(row)) for row in codes], np.int64)


@pytest.mark.parametrize("k", [1, 5, 15, 16, 21, 31])
def test_layout_converters_roundtrip(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (64, k), dtype=np.uint8)
    codes[0] = 0
    codes[1] = 3                       # the all-T key: every value bit set
    words = np.stack([jenc.key_words_from_codes(c) for c in codes])
    vals = _values(codes)
    # sentinel rows ride along in both directions
    words = np.concatenate([words, np.full((3, words.shape[1]),
                                           0xFFFFFFFF, np.uint32)])
    vals = np.concatenate([vals, np.full(3, tenc.SENTINEL_KEY, np.int64)])
    assert words.shape[1] == jenc.words_per_key(k) == tenc.words_per_key(k)
    got_words = tenc.keys_i64_to_u32(vals, k)
    assert got_words.dtype == np.uint32
    np.testing.assert_array_equal(got_words, words)
    np.testing.assert_array_equal(tenc.keys_u32_to_i64(words, k), vals)


@pytest.mark.parametrize("L", [1, 16, 17, 60, 160])
def test_unpack_inverts_host_packer(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (7, L), dtype=np.uint8)
    packed = pack_batch_codes(codes)            # (B, ceil(L/16)) uint32
    got = tenc.unpack_codes_i32(torch.from_numpy(packed.view(np.int32)), L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), codes)


def test_encode_and_decode_match_reference():
    seq = "ACGTNacgtnRYKMSWBDHVU"
    np.testing.assert_array_equal(tenc.encode_seq(seq, allow_ambiguous=True),
                                  jenc.encode_seq(seq, allow_ambiguous=True))
    with pytest.raises(tenc.InvalidBaseError):
        tenc.encode_seq("ACGN")
    with pytest.raises(tenc.InvalidBaseError):
        tenc.encode_seq("ACG-", allow_ambiguous=True)
    rng = np.random.default_rng(1)
    for k in (3, 16, 31):
        codes = rng.integers(0, 4, (5, k), dtype=np.uint8)
        words = np.stack([jenc.key_words_from_codes(c) for c in codes])
        np.testing.assert_array_equal(
            np.stack([tenc.key_words_from_codes(c) for c in codes]), words)
        np.testing.assert_array_equal(tenc.codes_from_key_words(words, k),
                                      codes)
        assert tenc.decode_key_words(words, k) == jenc.decode_key_words(
            words, k)
        np.testing.assert_array_equal(
            tenc.decode_key_words_to_bytes(words, k),
            jenc.decode_key_words_to_bytes(words, k))


@pytest.mark.parametrize("kw,item", [
    (dict(gapped=True, l_len=32, c_min=80), "item 15"),
    (dict(gapped=True, r_len=32, c_min=80), "item 15"),
    (dict(k=64), "item 18"), (dict(k=101, canonical=True), "item 18")])
def test_options_not_ported_raise(kw, item):
    """The options ROADMAP items 15 and 18 ported (gapped windows over 31
    bases, keys over 63) now configure as kmer_tpu's do: the same key
    width, window span and overlap, and the device planes of
    ops/encode."""
    from kmer_tpu import KmerConfig as JaxConfig
    t, j = KmerConfig(**kw), JaxConfig(**kw)
    assert (t.n_bases, t.window_span, t.overlap, t.effective_mode) == (
        j.n_bases, j.window_span, j.overlap, j.effective_mode)
    # item 15: the general layout of L||R in place of K3's split; item
    # 18: more than two words
    assert t.plane_bases == tenc.word_bases(t.n_bases)
    assert len(t.plane_bases) > 2 or item == "item 15"


@pytest.mark.parametrize("kw", [dict(k=32), dict(k=63),
                                dict(seed_mask="11011"),
                                dict(k=33, compact=True), dict(k=45)])
def test_options_now_accepted(kw):
    """Two-word keys and spaced seeds count (ROADMAP items 5 and 8)."""
    cfg = KmerConfig(**kw)
    assert cfg.effective_mode == "sort"
    assert cfg.n_bases == (4 if "seed_mask" in kw else kw["k"])


def test_wide_keys_rejected_by_converters():
    """The one-word and pair converters refuse wider keys; the W-word
    layout (words64) takes any width."""
    with pytest.raises(ValueError, match="pairs"):
        tenc.keys_i64_to_u32(np.zeros(1, np.int64), 32)
    with pytest.raises(ValueError, match="pair"):
        tenc.pair_r_len(64)
    assert [tenc.words64(n) for n in (31, 32, 63, 64, 94, 95, 125, 126)] == [
        1, 2, 2, 3, 3, 4, 4, 5]
    assert KmerConfig().effective_mode == "sort"
    assert KmerConfig(mode="auto", k=5).effective_mode == "sort"
