"""The control, the reference with its keys in the next narrower
integer, is not correct by the numbers a run compares, while the
program's table is (the program's plain versions on the CPU, small
corpora)."""

import pytest

from perfbench import control

from .test_perfbench_faults import CELLS


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**40 + 7])
def test_control_fails_where_the_program_passes(cell, seed, small_on_cpu):
    got = control.readings(cell, seed, True)
    assert got["program"] == {"mismatched_rows": 0, "kmers_total_gap": 0}
    assert got["control"]["mismatched_rows"] > 0
