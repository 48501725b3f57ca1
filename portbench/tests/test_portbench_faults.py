"""The rest of a run on the CPU, with the timed path broken underneath:
``correct`` comes out false for each fault that the cell can have
(``pbcore/faults.py``)."""

import pytest

from tiny import run

CASES = [
    ("tsunami64.fit", "unchanged"),
    ("tsunami64.fit", "half_left_out"),
    ("tsunami64.fit", "altered"),
    ("large_n4096.fit", "unchanged"),
    ("large_n4096.fit", "wrong_gradient"),
    ("large_n4096.fit", "starts_drawn_otherwise"),
    ("large_n4096.fit", "altered"),
    ("tsunami64.sweep", "half_left_out"),
    ("tsunami64.sweep", "altered"),
    ("tsunami64.fit_4proc", "exchange_left_out"),
    ("tsunami64.fit_4proc", "unchanged"),
]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    line, rc, err = run(workload, fault=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
