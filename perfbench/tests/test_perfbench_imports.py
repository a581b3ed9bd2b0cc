"""No run loads JAX or the JAX package; the reference loads nothing of the
program.  Top-level module names are compared whole: the program's name
begins with the JAX package's."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.spec import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for m in {mods!r}:
    __import__(m)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_names(*mods):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, mods=list(mods))],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_names("perfbench.run", "perfbench.harness",
                       "perfbench.reference", "perfbench.tracing",
                       "perfbench.control", "kmer_tpu_torch",
                       "kmer_tpu_torch.cli")
    assert "kmer_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "kmer_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_names("perfbench.reference")
    assert not names & {"jax", "jaxlib", "flax", "kmer_tpu",
                        "kmer_tpu_torch", "chip_smoke", "bench"}


@pytest.mark.parametrize("loaded, found", [
    (["kmer_tpu_torch", "kmer_tpu_torch.ops"], []),
    (["kmer_tpu.config"], ["kmer_tpu"]),
    (["jax._src.core", "flax"], ["flax", "jax"]),
])
def test_loaded_forbidden_compares_whole_names(monkeypatch, loaded, found):
    mods = {n: None for n in loaded}
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.loaded_forbidden() == found
