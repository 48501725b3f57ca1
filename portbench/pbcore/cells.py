"""A cell of ``BENCHMARK.json``, found by its name, and everything that
belongs to it, found by name in data files and plug modules:

* its configuration: the ``file`` that ``BENCHMARK.json`` gives it, which
  names two modules of its own (below): ``data.generator`` and
  ``reference`` (default ``gp_ref``), and states its model's arguments
  (``fitloop.build``);
* its traffic: ``portbench/traffic/<traffic>.json``;
* its limits: ``portbench/limits/<workload>.json``;
* each per-layer metric's reader: ``portbench/metrics/<metric>.py``, whose
  ``read(run)`` returns the number, or ``None`` where it finds nothing; for
  a metric split by the end-to-end metric it moves (``<base>.<part>``), a
  ``<base>.py`` serves every part that has no file of its own.

A configuration's **data generator**, ``portbench/generators/<name>.py``,
gives, for the configuration's ``data`` entry ``data`` and a 32-bit
``seed``:

* ``problem(data, seed)``: inputs ``(n, D)`` and targets ``(outputs, n)``;
* ``simulator(x, data, seed)``: the noiseless function of the same seed at
  points ``x`` ``(m, D)``, ``(outputs, m)``.

Its **plain reference**, ``portbench/reference/<name>.py``, works out its
model again from the inputs and judges the program's outputs.  It imports
nothing of the program or of the harness.  Arrays are numpy, ``raw`` the
program's raw hyperparameters ``(B, P)`` (or ``(P,)``), ``nugget`` its
nuggets as the program reports them ``(B,)``, ``x`` ``(n, D)``, ``y``
``(B, n)`` (or ``(n,)``), ``device`` a torch device to compute on:

* ``priors(x)``: the model's priors for the inputs, handed back below;
* ``restart_points(priors, n_emulators, n_tries, seed)``: ``(E, T, P)``,
  the restart points that mogp-emulator's ``fit_GP_MAP`` draws with numpy's
  RNG seeded with ``seed``;
* ``seeded_raw(n_outputs, n_dim, seed)``: ``(E, P)``, the hyperparameters
  at which the sweep fits its emulators;
* ``judge(raw, nugget, x, y, priors, device)``: whether each nugget is one
  the model allows at ``raw``, and the negative log posterior there in
  float64 (NaN where it is not);
* ``own_fit(raw, x, y, priors, device, tf32=False)``: the nugget that the
  model itself takes at ``raw`` and the negative log posterior there (NaN
  where it has none);
* ``polish(raw0, nugget, x, y, priors, device)``: ``(nlp at raw0, the least
  nlp that the reference's own optimizer finds from there)``;
* ``implausibility(raw, nugget, x, y, q, obs_mean, obs_var, rank, device,
  tf32=False)``: ``(m,)``, the ``rank``-th largest implausibility over the
  emulators at points ``q``.

``tf32=True`` computes in float32 with TF32 products: the control, the
reference in the program's place one precision below the configuration's
float32.

Each module is loaded at its first use, once a process, and refused there
if it lacks a function: the reference only after the window in a fit, so
that its imports stay out of the set-up of a process that runs no fit
itself.

A later change adds a cell, a mix, a metric or a configuration by adding
such files and entries, without editing any file that is here.
"""

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DEFAULT_REFERENCE = "gp_ref"
GENERATOR = ("problem", "simulator")
REFERENCE = ("priors", "restart_points", "seeded_raw", "judge", "own_fit", "polish",
             "implausibility")


class Cell:
    """One workload: ``name``, ``chips``, ``config``, ``traffic``,
    ``limits``, and the ``end_to_end`` and ``per_layer`` metric entries
    that it reports."""

    def __init__(self, manifest, name, overrides=None):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError("BENCHMARK.json has no workload {!r}".format(name))
        w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = _load(ROOT / configs[w["config"]]["file"])
        self.traffic = _load(BENCH / "traffic" / "{}.json".format(w["traffic"]))
        self.limits = _load(BENCH / "limits" / "{}.json".format(name))["limits"]
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)
        self.end_to_end = [m for m in manifest["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if _reports(m, name)]


def _load(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load(name, overrides=None, manifest=None):
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``manifest``);
    ``overrides`` maps ``config`` / ``traffic`` / ``limits`` to entries
    that replace the files' (the tests' small sizes)."""
    return Cell(manifest or _load(ROOT / "BENCHMARK.json"), name, overrides)


def reader(metric):
    """The ``read`` function of ``portbench/metrics/<metric>.py``, or of
    ``<base>.py`` for a ``<base>.<part>`` that has no file of its own."""
    path = BENCH / "metrics" / "{}.py".format(metric)
    if not path.exists() and "." in metric:
        path = BENCH / "metrics" / "{}.py".format(metric.rsplit(".", 1)[0])
    return _module(path).read


def generator(config):
    """The data generator module that ``config`` names."""
    return _plug("generators", config["data"]["generator"], GENERATOR)


def reference(config):
    """The plain reference module that ``config`` names."""
    return _plug("reference", config.get("reference", DEFAULT_REFERENCE), REFERENCE)


def _plug(kind, name, interface):
    module = _module(BENCH / kind / "{}.py".format(name))
    missing = [f for f in interface if not callable(getattr(module, f, None))]
    if missing:
        raise AttributeError("portbench/{}/{}.py lacks {}".format(kind, name, ", ".join(missing)))
    return module


_loaded = {}


def _module(path):
    """The module at ``path``, loaded once a process."""
    path = Path(path)
    if path not in _loaded:
        if not path.is_file():
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location(
            "portbench_{}_{}".format(path.parent.name, path.stem.replace(".", "_")), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]
