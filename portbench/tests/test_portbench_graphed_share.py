"""``fit.graphed_share``: the program's counters ``lbfgs.evals_graphed`` and
``lbfgs.evals_eager`` read as the graphed share of the window's objective
evaluations; nothing where neither was counted (a program without them)."""

import types

import pytest

from pbcore import cells


@pytest.mark.parametrize("counts,share", [
    ({}, None),
    ({"gp.nlp_lanes": 96}, None),
    ({"lbfgs.evals_eager": 96}, 0.0),
    ({"lbfgs.evals_graphed": 960}, 1.0),
    ({"lbfgs.evals_graphed": 768, "lbfgs.evals_eager": 192}, 0.8),
])
def test_the_share_of_the_counters(counts, share):
    from mogp_tpu_torch.utils import metrics

    metrics.clear()
    with metrics.recording():
        for name, n in counts.items():
            metrics.count(name, n)
    read = cells.reader("fit.graphed_share")
    run = types.SimpleNamespace(records=[{}], procs=[[{}]], trace=None)
    assert read(run) == share
    assert read(types.SimpleNamespace(records=[], procs=[[]], trace=None)) is None
    metrics.clear()
