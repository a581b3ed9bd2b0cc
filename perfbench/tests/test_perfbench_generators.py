"""The traffic generator: seeded, and the corpus it says it wrote."""

import numpy as np
import pytest
import torch

from perfbench import reference
from perfbench.generators import genome_reads

PARAMS = {"genome_len": 3000, "n_reads": 50, "read_len": 150,
          "error_rate": 0.01, "revcomp_share": 0.5}


def _genome(seed, n):
    """The genome a corpus of `seed` is drawn from: the first draw."""
    gen = genome_reads.generator_for(seed, "cpu")
    return bytes(genome_reads.ASCII[torch.randint(
        0, 4, (n,), generator=gen, dtype=torch.uint8).long()].numpy())


def _write(tmp_path, name, params, seed):
    path = tmp_path / name
    lengths = genome_reads.write(str(path), params, seed)
    return path.read_bytes(), lengths


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**63 + 11, -3])
def test_same_seed_same_bytes(tmp_path, seed):
    a, la = _write(tmp_path, "a", PARAMS, seed)
    b, lb = _write(tmp_path, "b", PARAMS, seed)
    assert a == b and np.array_equal(la, lb)
    c, _ = _write(tmp_path, "c", PARAMS, seed + 1)
    assert c != a


@pytest.mark.parametrize("read_len", [150, [20, 90]])
def test_corpus_parses_to_its_lengths(tmp_path, read_len):
    params = {**PARAMS, "read_len": read_len}
    data, lengths = _write(tmp_path, "r", params, 3)
    codes, rec = reference.parse(str(tmp_path / "r"), "cpu")
    assert np.array_equal(torch.bincount(rec).numpy(), lengths)
    if isinstance(read_len, list):
        assert lengths.min() >= 20 and lengths.max() <= 90
    assert data.startswith(b">r0000000000\n")
    assert data.count(b">r") == len(lengths)


def test_reads_come_from_the_genome(tmp_path):
    params = {**PARAMS, "error_rate": 0.0, "revcomp_share": 0.0,
              "n_reads": 20}
    data, _ = _write(tmp_path, "g", params, 9)
    genome = _genome(9, params["genome_len"])
    for line in data.split(b"\n")[1::2]:
        assert line in genome


def test_errors_and_strands_at_their_rates(tmp_path):
    params = {**PARAMS, "genome_len": 200_000, "n_reads": 4000,
              "error_rate": 0.02}
    data, _ = _write(tmp_path, "e", params, 4)
    genome = _genome(4, params["genome_len"])
    rc = genome[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    exact_fwd = exact_rc = 0
    for line in data.split(b"\n")[1::2]:
        exact_fwd += line in genome
        exact_rc += line in rc
    # a read is error-free with probability 0.98 ** 150 ~ 4.8%
    assert 80 < exact_fwd + exact_rc < 320
    assert abs(exact_fwd - exact_rc) < 0.5 * (exact_fwd + exact_rc)
