"""A rehearsal of each cell's traffic on the CPU at a small size: it runs,
reports its metrics, and the comparison holds; the control in the
program's place (the reference in TF32) does not."""

import json

import pytest

from pbcore import cells

from tiny import run

WORKLOADS = [w["name"] for w in
             json.loads((cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(workload, trace):
    line, rc, err = run(workload, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = cells.load(workload)
    expect = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in expect}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names and line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    line, rc, err = run(workload, control=True)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
