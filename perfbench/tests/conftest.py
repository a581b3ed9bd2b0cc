import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a corpus small enough for the CPU: the cells' traffic at a few hundred
# reads of a short genome
SMALL = {"n_reads": 300, "genome_len": 5000}


def shrink(monkeypatch, params: dict) -> None:
    """Every Spec's traffic with `params` in place of its own."""
    from perfbench.spec import Spec
    init = Spec.__init__

    def small_init(self, workload):
        init(self, workload)
        self.traffic = {**self.traffic,
                        "params": {**self.traffic["params"], **params}}
    monkeypatch.setattr(Spec, "__init__", small_init)


@pytest.fixture
def small_on_cpu(monkeypatch):
    """Runs with the look for a card skipped: the program's plain
    versions on the CPU, the cells' traffic at SMALL."""
    from torch.profiler import ProfilerActivity

    from perfbench import card
    stand_in = {
        "DEVICE": "cpu", "PLATFORM": "cpu",
        "require": lambda chips: None,
        "open_card": lambda libraries: {"name": "cpu",
                                        "power_limit": "none"},
        "sync": lambda: None, "free": lambda: None,
        "reset_peak": lambda: None, "peak_bytes": lambda: 0,
        "activities": lambda: [ProfilerActivity.CPU]}
    for name, value in stand_in.items():
        monkeypatch.setattr(card, name, value)
    shrink(monkeypatch, SMALL)
