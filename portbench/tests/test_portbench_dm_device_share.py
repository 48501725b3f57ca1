"""``sweep.dm_device_share``: 1.0 in a traced run of the universal-kriging
sweep (a formula mean, built on the device), nothing from an empty
recorder."""

import types

from pbcore import cells
from tiny import run

NAME = "sweep.dm_device_share"


def test_an_empty_recorder_reads_nothing():
    from mogp_tpu_torch.utils import metrics

    metrics.clear()
    read = cells.reader(NAME)
    assert read(types.SimpleNamespace(records=[{}])) is None
    assert read(types.SimpleNamespace(records=[])) is None


def test_the_formula_mean_sweep_reads_one():
    line, rc, err = run("ukriging64.sweep", trace=1)
    assert rc == 0, err[-3000:]
    assert line["metrics"][NAME]["value"] == 1.0
