"""The ``ukriging64`` configuration on the CPU at a small size: both cells
through ``cli.run_cell``, correct as they are and not under the control or
a fault that leaves out part of the mean's mathematics; its reference
against the repository's; its priors as the configuration states them; the
readers of its two device metrics on a fabricated run, and its program
metrics in a traced run.  Its small size is in ``tiny.SMALL`` by
``portbench/conftest.py``."""

import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import tiny
from pbcore import cells, work, work_mean

sys.path.insert(0, str(cells.ROOT / "tests"))
import ref_universal_kriging as REPO  # noqa: E402
from reference import uk_ref as UK  # noqa: E402

CPU = torch.device("cpu")
CELLS = ["ukriging64.fit", "ukriging64.sweep"]
PLANT = """
import sys
sys.path[:0] = [{root!r}, {bench!r}]
import control_uk
control_uk.FAULTS[{fault!r}]()
"""


def _run_with_mean_fault(workload, fault):
    """A small run with a fault of ``control_uk.py`` planted first."""
    ov, _ = tiny.overrides(workload)
    code = PLANT.format(root=str(cells.ROOT), bench=str(cells.BENCH), fault=fault) + \
        tiny.CODE.format(root=str(cells.ROOT), bench=str(cells.BENCH), fault=None,
                         control=False, workload=workload, ov=json.dumps(ov), across=False,
                         seed=2**31 + 17, seconds=1.0, trace=0, tree=None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=str(cells.ROOT))
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    return (json.loads(lines[-1]) if lines else None), p.returncode, p.stderr


@pytest.mark.parametrize("workload,control", [(w, c) for w in CELLS for c in (False, True)])
def test_a_small_cell_is_correct_and_its_control_is_not(workload, control):
    line, rc, err = tiny.run(workload, control=control)
    assert rc == 0, err[-3000:]
    assert line["correct"] is (not control), line["checks"]
    assert set(line["checks"]) == set(cells.load(workload).limits)
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("ukriging64.fit", "logdet_A_left_out"),
    ("ukriging64.fit", "B_inv_left_out"),
    ("ukriging64.sweep", "B_inv_left_out"),
    ("ukriging64.fit", "state_unchanged"),
])
def test_a_mean_fault_is_caught(workload, fault):
    line, rc, err = _run_with_mean_fault(workload, fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def _problem(n=24, D=3, E=4, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(n, D))
    y = np.stack([x @ rng.randn(D) + np.sin(3 * x[:, 0] + e) for e in range(E)])
    raw = np.concatenate([rng.uniform(-2, 0.5, (E, D)), rng.uniform(-1, 0.5, (E, 1)),
                          rng.uniform(-9, -6, (E, 1))], 1)
    return x, y, raw


def test_the_benchmarks_copy_agrees_with_the_repositorys_reference():
    x, y, raw = _problem()
    pr = UK.priors(x)
    for key, value in REPO.prior_arrays(x.shape[1]).items():
        assert np.array_equal(pr[key], value)
    t = [torch.tensor(a) for a in (raw, x, y)]
    assert torch.equal(UK.nlp(*t, pr), REPO.nlp(*t, pr))
    q = torch.tensor(np.random.RandomState(1).uniform(size=(50, 3)))
    for a, b in zip(UK.predict(*t, pr, q), REPO.predict(*t, pr, q)):
        assert torch.equal(a, b)
    for a, b in zip(UK.predict(*t, pr, q, mm=UK.tf32_mm), REPO.predict(*t, pr, q, mm=REPO.tf32_mm)):
        assert torch.equal(a, b)
    assert np.array_equal(UK.restart_points(pr, 3, 5, 9), REPO.restart_points(pr, 3, 5, 9))
    # the interface: the judged nugget is exp(raw[-1]) to float32 rounding
    nug = np.exp(raw[:, -1])
    on, v = UK.judge(raw, nug * (1 + 1e-7), x, y, pr, CPU)
    assert on.all() and np.allclose(v, REPO.nlp(*t, pr).numpy(), rtol=1e-12)
    assert not UK.judge(raw, nug * 1.01, x, y, pr, CPU)[0].any()
    own, at = UK.own_fit(raw, x, y, pr, CPU)
    assert np.array_equal(own, nug) and np.array_equal(at, v)
    start, best = UK.polish(raw[0], nug[0], x, y[0], pr, CPU)
    assert start == pytest.approx(v[0], rel=1e-12) and best < start


def test_the_configuration_states_the_references_priors():
    config = cells.load("ukriging64.fit").config
    model, D = config["model"], config["data"]["n_dim"]
    pr = UK.priors(np.zeros((2, D)))
    assert model["mean"] == "+".join("x[{}]".format(d) for d in range(D))
    assert work_mean.mean_terms(config) == D + 1 == len(pr["mean"])
    p = model["priors"]
    assert p["mean"] == {"mean": pr["mean"].tolist(), "cov": pr["mean_cov"].tolist()}
    assert p["corr"] == [["LogNormalPrior", *row] for row in pr["corr"].tolist()]
    assert p["cov"] == ["InvGammaPrior", *pr["cov"].tolist()]
    assert p["nugget"] == ["GammaPrior", *pr["nugget"].tolist()]
    assert (model["kernel"], model["nugget"], p["nugget_type"]) == ("Matern52", "fit", "fit")
    assert UK.seeded_raw(64, D, 3).shape == (64, D + 2)


def test_mean_work_by_hand():
    # n = 2, D = 1, M = 2, one output: the cross-covariance 2 * (3 + 8),
    # the substitution 4, the mean terms 2 * 2 * 2 + 3 * 2, LA^-1 r 4, the
    # norms 4 * 2 + 2 * 2
    assert work_mean.predict_flops_mean(2, 1, 2, 1) == 22 + 4 + 14 + 4 + 12
    # the headline shapes count more than the zero-mean squared exponential
    assert work_mean.predict_flops_mean(210, 14, 15, 64) > work.predict_flops(210, 14, 64)
    assert work_mean.mean_terms({"model": {"mean": "zero"}, "data": {"n_dim": 2}}) == 0
    assert work_mean.mean_terms({"model": {"mean": "x[0]+x[1]"}, "data": {"n_dim": 2}}) == 3
    assert work_mean.mean_terms({"model": {"mean": "x[0]*x[1]"}, "data": {"n_dim": 2}}) == 4


def _run(config, traffic, records, trace):
    return types.SimpleNamespace(cell=types.SimpleNamespace(config=config, traffic=traffic),
                                 records=records, procs=[records], trace=trace)


def test_the_two_readers_on_a_fabricated_run():
    config = cells.load("ukriging64.sweep").config
    d = config["data"]
    trace = {"kernel_s": 10.0, "window_s": 20.0, "busy_s": 15.0}
    run = _run(config, {"rank": 1}, [{"points": 10**7}] * 4, trace)
    flops = 4e7 * work_mean.predict_flops_mean(d["n_points"], d["n_dim"], 15, d["n_outputs"])
    mfu = cells.reader("sweep.mean_mfu_pct")(run)
    assert mfu == pytest.approx(100 * flops / (20.0 * 165e12))
    roof = cells.reader("sweep.mean_roofline")(run)
    assert roof == pytest.approx(100 * flops / 165e12 / 10.0) and 0 < mfu < roof < 100
    assert cells.reader("sweep.mean_roofline")(_run(config, {"rank": 1}, [], None)) is None
    assert cells.reader("sweep.mean_mfu_pct")(_run(config, {"rank": 1}, [], None)) is None


def test_a_traced_small_fit_reads_its_program_metrics():
    # every per-layer metric that the manifest gives the fit cell and that
    # the program's spans and counters carry (a device trace has no CPU run)
    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in manifest["per_layer"]
             if "ukriging64.fit" in m.get("workloads", []) and m["source"] != "device_trace"]
    assert len(names) == 9
    line, rc, err = tiny.run("ukriging64.fit", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    for name in names:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
