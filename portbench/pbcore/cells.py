"""A cell of ``BENCHMARK.json``, found by its name, and everything that
belongs to it, found by name in data files:

* its configuration: the ``file`` that ``BENCHMARK.json`` gives it;
* its traffic: ``portbench/traffic/<traffic>.json``;
* its limits: ``portbench/limits/<workload>.json``;
* each per-layer metric's reader: ``portbench/metrics/<metric>.py``, whose
  ``read(run)`` returns the number, or ``None`` where it finds nothing; for
  a metric split by the end-to-end metric it moves (``<base>.<part>``), a
  ``<base>.py`` serves every part that has no file of its own.

A later change adds a cell, a mix or a metric by adding such files and
entries, without editing any file that is here.
"""

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


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
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
