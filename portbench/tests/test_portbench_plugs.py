"""A configuration added by files alone (its file, a data generator and a
plain reference of its own, traffic and limits) runs through
``cli.run_cell`` on the CPU, and ``fitloop.build`` hands the port every
model argument that a configuration's file states."""

import json

import numpy as np
import pytest
import torch

import mogp_tpu_torch as mt
from pbcore import cells, fitloop
from tiny import plug_tree, run

FIT = ["plug_gen.problem", "plug_ref.priors", "plug_ref.restart_points", "plug_ref.judge",
       "plug_ref.own_fit", "plug_ref.polish"]
SWEEP = ["plug_gen.problem", "plug_gen.simulator", "plug_ref.priors", "plug_ref.seeded_raw",
         "plug_ref.judge", "plug_ref.implausibility"]


@pytest.mark.parametrize("workload,control,reached", [
    ("plug.fit", False, FIT),
    ("plug.sweep", False, SWEEP),
    ("plug.fit", True, FIT),
    ("plug.sweep", True, SWEEP + ["plug_ref.own_fit"]),
])
def test_a_configuration_added_by_files_alone(tmp_path, workload, control, reached):
    line, rc, err = run(workload, control=control, tree=plug_tree(tmp_path))
    assert rc == 0, err[-3000:]
    assert line["correct"] is (not control), line["checks"]
    assert set(line["checks"]) == set(json.loads(
        (tmp_path / "portbench" / "limits" / "{}.json".format(workload)).read_text())["limits"])
    assert line["attempted"] >= 1 and line["failed"] == 0 and "setup_s" in line["metrics"]
    marked = {l for l in err.splitlines() if l.startswith("plug_")}
    assert marked == set(reached), marked


def test_a_configuration_loads_its_modules_by_name(tmp_path, monkeypatch):
    plug_tree(tmp_path)
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    monkeypatch.setattr(cells, "BENCH", tmp_path / "portbench")
    cell = cells.load("plug.fit")
    assert cells.generator(cell.config).__file__ == str(
        tmp_path / "portbench" / "generators" / "plug_gen.py")
    assert cells.reference(cell.config).__file__ == str(
        tmp_path / "portbench" / "reference" / "plug_ref.py")
    with pytest.raises(FileNotFoundError):   # the default is no file of this tree
        cells.reference(cells.load("plug.fit", {"config": {"reference": "gp_ref"}}).config)
    (tmp_path / "portbench" / "reference" / "half_ref.py").write_text("def priors(x):\n    pass\n")
    with pytest.raises(AttributeError, match="restart_points"):
        cells.reference(cells.load("plug.fit", {"config": {"reference": "half_ref"}}).config)


def _example3(cls="MultiOutputGP"):
    """Example 3 of ``demos/gp_demos.py``: a linear mean with its priors,
    lognormal correlation priors, an inverse-gamma covariance prior and a
    fitted nugget with a gamma prior, over the Matern 5/2 kernel."""
    return {"model": {
        "class": cls, "kernel": "Matern52", "mean": "x[0]+x[1]", "nugget": "fit",
        "priors": {"mean": {"mean": [0.0, 0.0, 0.0], "cov": [1.0, 1.0, 1.0]},
                   "corr": [["LogNormalPrior", 1.0, 1.0], ["LogNormalPrior", 1.0, 1.0]],
                   "cov": ["InvGammaPrior", 1.0, 1.0], "nugget": ["GammaPrior", 1.0, 1.0],
                   "nugget_type": "fit"},
        "dtype": "float64"}}


@pytest.mark.parametrize("cls", ["MultiOutputGP", "GaussianProcess"])
def test_build_states_every_model_argument(cls):
    x = np.random.RandomState(0).uniform(size=(20, 2))
    y = np.stack([x.sum(1), x[:, 0] - x[:, 1]])
    model = fitloop.build(_example3(cls), x, y, torch.device("cpu"))
    for em in fitloop.emulators(model):
        assert isinstance(em.kernel, mt.Kernel.Matern52)
        assert em.n_mean == 3 and em.nugget_type == "fit" and em.n_params == 4
        p = em.priors
        assert p.nugget_type == "fit"
        assert p.mean.mean.tolist() == [0.0, 0.0, 0.0] and p.mean.cov.tolist() == [1.0, 1.0, 1.0]
        assert all(type(c) is mt.LogNormalPrior and (c.shape, c.scale) == (1.0, 1.0)
                   for c in p.corr) and len(p.corr) == 2
        assert type(p.cov) is mt.InvGammaPrior and (p.cov.shape, p.cov.scale) == (1.0, 1.0)
        assert type(p.nugget) is mt.GammaPrior and (p.nugget.shape, p.nugget.scale) == (1.0, 1.0)


@pytest.mark.parametrize("config", ["tsunami64", "large_n4096"])
def test_the_configurations_make_the_same_call(config, monkeypatch):
    calls = []
    for cls in ("MultiOutputGP", "GaussianProcess"):
        monkeypatch.setattr(mt, cls, lambda x, y, name=cls, **kw: calls.append((name, kw)))
    cell = cells.load(next(w["name"] for w in json.loads(
        (cells.ROOT / "BENCHMARK.json").read_text())["workloads"] if w["config"] == config))
    fitloop.build(cell.config, np.zeros((3, 2)), np.zeros((1, 3)), torch.device("cpu"))
    cls = "MultiOutputGP" if config == "tsunami64" else "GaussianProcess"
    assert calls == [(cls, {"kernel": "SquaredExponential", "nugget": "adaptive",
                            "device": torch.device("cpu"), "dtype": torch.float32})]


@pytest.mark.parametrize("change,error", [
    ({"means": "x[0]"}, ValueError),                        # a key build does not know
    ({"class": "GP"}, ValueError),
    ({"priors": dict(_example3()["model"]["priors"], corr=[["Lognormal", 1.0, 1.0]] * 2)},
     ValueError),
    ({"priors": dict(_example3()["model"]["priors"], corr_priors=[])}, TypeError),
])
def test_an_unknown_model_key_raises(change, error):
    config = _example3()
    config["model"].update(change)
    with pytest.raises(error):
        fitloop.build(config, np.zeros((3, 2)), np.zeros((1, 3)), torch.device("cpu"))
