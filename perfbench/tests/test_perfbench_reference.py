"""The plain reference against a count by hand, and the comparison."""

import collections

import numpy as np
import pytest
import torch

from perfbench import reference

COMP = str.maketrans("ACGT", "TGCA")
READS = ["ACGTTGCAACGGTACCATGCAGTTTACGATCAGGCATTACGGATCCATGCAAGTCCGATAGCTAGG"
         "CATCGATTAGC",
         "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTAAAAA",
         "GGGCCCATATATCGCGTATAGCGCATATGGGCCCATATATCGCGTATAGCGCATATGCATGCAAT",
         "ACGT"]


def by_hand(reads, k, canonical):
    """k-mer strings and counts, by Python strings."""
    got = collections.Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            s = r[i:i + k]
            if canonical:
                s = min(s, s.translate(COMP)[::-1])
            got[s] += 1
    return got


def as_strings(cols, counts, k):
    """The reference's key columns back to strings."""
    out = {}
    hi = cols[0].tolist() if len(cols) == 2 else [0] * len(counts)
    lo = cols[-1].tolist()
    for h, l, c in zip(hi, lo, counts.tolist()):
        v = (h << 62) | l
        out["".join("ACGT"[(v >> 2 * (k - 1 - j)) & 3]
                    for j in range(k))] = c
    return out


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "hand.fasta"
    # a multi-line record, a lower-case one, CRLF line ends
    path.write_bytes(
        (">a\n" + READS[0][:40] + "\n" + READS[0][40:] + "\n"
         ">b\r\n" + READS[1].lower() + "\r\n"
         ">c\n" + READS[2] + "\n>d\n" + READS[3] + "\n").encode())
    return str(path)


@pytest.mark.parametrize("k", [21, 31, 32, 55])
@pytest.mark.parametrize("canonical", [True, False])
def test_counts_match_a_count_by_hand(corpus, k, canonical):
    cols, counts = reference.count_kmers(corpus, k, canonical, "cpu")
    assert as_strings(cols, counts, k) == dict(by_hand(READS, k, canonical))
    assert len(cols) == (1 if k <= 31 else 2)


def test_both_strands_count_as_one(tmp_path):
    fwd = READS[0]
    path = tmp_path / "two.fasta"
    path.write_text(f">f\n{fwd}\n>r\n{fwd.translate(COMP)[::-1]}\n")
    for k in (21, 55):
        _, counts = reference.count_kmers(str(path), k, True, "cpu")
        assert set(counts.tolist()) == {2}


def test_blocks_give_the_same_table(corpus, monkeypatch):
    want = reference.count_kmers(corpus, 21, True, "cpu")
    monkeypatch.setattr(reference, "BLOCK", 7)
    got = reference.count_kmers(corpus, 21, True, "cpu")
    assert reference.mismatched_rows(*got, *want) == 0


def test_refuses_other_bases(tmp_path):
    path = tmp_path / "n.fasta"
    path.write_text(">n\nACGTNACGT\n")
    with pytest.raises(ValueError):
        reference.count_kmers(str(path), 3, True, "cpu")


@pytest.mark.parametrize("k", [21, 55])
def test_reads_the_programs_table_layout(corpus, k):
    """words_to_cols reads KmerTable's key words as the reference's
    columns (the table here is the program's, on the CPU)."""
    from kmer_tpu_torch import count_fasta
    table = count_fasta(corpus, k=k, canonical=True, device="cpu")
    cols = [torch.from_numpy(c) for c in reference.words_to_cols(
        table.keys, k)]
    got = as_strings(cols, torch.from_numpy(table.counts), k)
    assert got == dict(by_hand(READS, k, True))


def _table(rows):
    cols = [torch.tensor([r[0] for r in rows], dtype=torch.int64),
            torch.tensor([r[1] for r in rows], dtype=torch.int64)]
    return cols, torch.tensor([r[2] for r in rows], dtype=torch.int64)


WANT = [(0, 1, 3), (0, 5, 1), (2, 0, 7), (2, 9, 2)]


@pytest.mark.parametrize("rows, expect", [
    (WANT, 0),
    ([(0, 1, 3), (0, 5, 2), (2, 0, 7), (2, 9, 2)], 2),      # a count
    ([(0, 1, 3), (2, 0, 7), (2, 9, 2)], 1),                 # a row lost
    ([(0, 1, 3), (0, 5, 1), (1, 1, 1), (2, 0, 7), (2, 9, 2)], 1),  # extra
    ([(0, 1, 3), (0, 5, 1), (0, 5, 1), (2, 0, 7), (2, 9, 2)], 2),  # twice
    ([(0, 5, 1), (0, 1, 3), (2, 0, 7), (2, 9, 2)], 1),      # order
    ([], 4),
])
def test_mismatched_rows(rows, expect):
    got = _table(rows) if rows else ([torch.zeros(0, dtype=torch.int64)] * 2,
                                     torch.zeros(0, dtype=torch.int64))
    assert reference.mismatched_rows(*got, *_table(WANT)) == expect


def test_words_to_cols_at_the_edges():
    # k = 55: value bits 0..109; the low column is bits 0..61
    v = (0x123456789ABC << 62) | ((1 << 62) - 1)
    words = np.array([[(v >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]],
                     np.uint32)
    hi, lo = reference.words_to_cols(words, 55)
    assert int(hi[0]) == 0x123456789ABC and int(lo[0]) == (1 << 62) - 1
    (one,) = reference.words_to_cols(np.array([[0x3FF, 0xFFFFFFFF]],
                                              np.uint32), 21)
    assert int(one[0]) == (1 << 42) - 1
