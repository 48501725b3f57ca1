"""The metrics that read the program's own spans and counters
(``mogp_tpu_torch.utils.metrics``): a finite number in a traced run of each
cell that lists them, nothing from an empty recorder."""

import json
import math
import types

import pytest

from pbcore import cells
from tiny import run

MANIFEST = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
SEVEN = ["fit.nlp_ms_per_fit", "fit.nlp_lanes_per_fit", "fit.sync_ms_per_fit",
         "fit.host_ms_per_fit", "fit.chol_matrices_per_fit", "sweep.inputs_ms_per_wave",
         "sweep.rank_select_ms_per_wave"]
WORKLOADS = {m["name"]: m["workloads"] for m in MANIFEST["per_layer"] if m["name"] in SEVEN}
CELLS = sorted({w for ws in WORKLOADS.values() for w in ws})


def test_each_is_in_the_manifest():
    assert sorted(WORKLOADS) == sorted(SEVEN)
    assert CELLS == ["large_n4096.fit", "tsunami64.fit", "tsunami64.sweep"]


@pytest.mark.parametrize("workload", CELLS)
def test_each_reads_a_finite_number_in_a_traced_run(workload):
    line, rc, err = run(workload, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    for name, workloads in WORKLOADS.items():
        if workload in workloads:
            value = line["metrics"][name]["value"]
            assert math.isfinite(value) and value > 0.0, (name, value)


@pytest.mark.parametrize("name", SEVEN)
def test_an_empty_recorder_reads_nothing(name):
    from mogp_tpu_torch.utils import metrics

    metrics.clear()
    read = cells.reader(name)
    cell = types.SimpleNamespace(config={}, traffic={})
    assert read(types.SimpleNamespace(cell=cell, records=[{}], procs=[[{}]], trace=None)) is None
    assert read(types.SimpleNamespace(cell=cell, records=[], procs=[[]], trace=None)) is None
