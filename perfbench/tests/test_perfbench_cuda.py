"""On the card: a short run of each cell is correct, and the control is
not (small corpora; the full sizes run through run.py and control.py)."""

import pytest
import torch

from perfbench import control, harness

from .conftest import SMALL, shrink
from .test_perfbench_faults import CELLS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(card, cell, monkeypatch):
    shrink(monkeypatch, {"n_reads": 20000})
    res = harness.run_cell(cell, 2**31 + 99, 0.0, True)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    for name in ("k1_roofline", "k6_roofline", "merge_roofline"):
        assert 0 < res["metrics"][name]["value"] <= 105


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell, monkeypatch):
    shrink(monkeypatch, SMALL)
    got = control.readings(cell, 7, True)
    assert got["program"]["mismatched_rows"] == 0
    assert got["control"]["mismatched_rows"] > 0
