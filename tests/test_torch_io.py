"""Host ingest of the port against kmer_tpu's: parse_seqs,
iter_parse_chunks and iter_batches give the same codes, offsets and
batches on FASTA, FASTQ, gzip and BGZF inputs, and the corpus
generators write the same text for the same seed."""

import gzip

import numpy as np
import pytest

from kmer_tpu.io import fasta as jf
from kmer_tpu.io import generator as jg
from kmer_tpu.io.bgzf import write_bgzf
from kmer_tpu_torch.io import fasta as tf
from kmer_tpu_torch.io import generator as tg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, sample_fasta_path):
    """name -> (path, allow_ambiguous, min_qual)."""
    d = tmp_path_factory.mktemp("io")
    text = open(sample_fasta_path, "rb").read()
    fq = d / "reads.fastq"
    fq.write_text(jg.random_reads_fastq(40, 90, seed=3, qual_range=(2, 40)))
    gz = d / "sample.fasta.gz"
    gz.write_bytes(gzip.compress(text))
    bgz = d / "sample.fasta.bgz"
    write_bgzf(str(bgz), text, block=4096)
    amb = d / "amb.fasta"
    amb.write_text(">a\nACGTNNACGTRYACGTACGT\n>b\nNNNN\n>c\n\n>d\nacgtnACGT\n")
    return {"fasta": (sample_fasta_path, False, 0),
            "fastq": (str(fq), True, 20),
            "gzip": (str(gz), False, 0),
            "bgzf": (str(bgz), False, 0),
            "ambiguous": (str(amb), True, 0)}


NAMES = ["fasta", "fastq", "gzip", "bgzf", "ambiguous"]


@pytest.mark.parametrize("name", NAMES)
def test_parse_seqs_matches(inputs, name):
    path, amb, mq = inputs[name]
    want = jf.parse_seqs(path, allow_ambiguous=amb, min_qual=mq)
    got = tf.parse_seqs(path, allow_ambiguous=amb, min_qual=mq)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("max_bases", [1 << 20, 5000])
@pytest.mark.parametrize("name", NAMES)
def test_iter_parse_chunks_matches(inputs, name, max_bases):
    """1 MiB: the whole-file multithreaded parse; 5000 bases: the
    chunked native handle with resume cursors."""
    path, amb, mq = inputs[name]
    want = list(jf.iter_parse_chunks(path, max_bases=max_bases,
                                     allow_ambiguous=amb, min_qual=mq))
    got = list(tf.iter_parse_chunks(path, max_bases=max_bases,
                                    allow_ambiguous=amb, min_qual=mq))
    assert len(got) == len(want) > 0
    for (gc, go, gcur), (wc, wo, wcur) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(go, wo)
        assert gcur == wcur


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("max_len,batch_reads", [(96, 64), (64, 7), (32, 500)])
def test_iter_batches_match(sample_fasta_path, max_len, batch_reads, packed):
    """Split records with overlap seams, a padded last batch, and both
    row formats."""
    codes, offsets = jf.parse_seqs(sample_fasta_path)
    kw = dict(batch_reads=batch_reads, max_len=max_len, overlap=20,
              packed=packed)
    want = list(jf.iter_batches(codes, offsets, **kw))
    got = list(tf.iter_batches(codes, offsets, **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for f in ("codes", "lengths", "start_limits"):
            assert getattr(g, f).dtype == getattr(w, f).dtype
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.packed_width == w.packed_width
    np.testing.assert_array_equal(tf.segment_records(offsets, max_len, 20),
                                  jf.segment_records(offsets, max_len, 20))


@pytest.mark.parametrize("L", [1, 16, 33, 160])
def test_pack_batch_codes_matches(L):
    codes = np.random.default_rng(L).integers(0, 5, (9, L), dtype=np.uint8)
    got = tf.pack_batch_codes(codes)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jf.pack_batch_codes(codes))


def test_empty_input_batches(tmp_path):
    p = tmp_path / "empty.fasta"
    p.write_text("")
    assert list(tf.iter_parse_chunks(str(p))) == []
    codes, offsets = tf.parse_seqs(str(p))
    (b,) = list(tf.iter_batches(codes, offsets, batch_reads=4, max_len=32,
                                overlap=4, packed=True))
    assert b.codes.shape == (4, 2) and not b.lengths.any()


def test_parse_errors_match(tmp_path):
    bad = tmp_path / "bad.fasta"
    bad.write_text(">r\nACGTN\n")
    with pytest.raises(tf.InvalidBaseError):
        tf.parse_seqs(str(bad))
    fq = tmp_path / "q.fastq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="min_qual"):
        tf.parse_seqs(str(fq), min_qual=20)


def test_generators_match_reference():
    assert tg.random_reads_fasta(20, 33, seed=4) == \
        jg.random_reads_fasta(20, 33, seed=4)
    for err in (0.0, 0.01):
        assert tg.genome_reads_fasta(50, 40, genome_len=500, seed=7,
                                     error_rate=err) == \
            jg.genome_reads_fasta(50, 40, genome_len=500, seed=7,
                                  error_rate=err)
