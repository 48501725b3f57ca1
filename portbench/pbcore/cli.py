"""One run of one cell: set-up, the window, the comparison, the result line.

``python3 portbench/run.py --workload W --seed S --seconds T --trace 0|1``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines of standard error repeat.

A run needs the cards its cell asks for: without them it prints no result
and exits with 3.  One that finds JAX or the JAX package loaded once its
window has closed exits with 4.
"""

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import types

import numpy as np

from . import cells, data, fitloop, guard, procs, sweeploop

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "worker.py")
# seconds a cell across processes may take, within the run's 360
WORKER_DEADLINE = 330


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fit_across_processes(cell, seed, seconds, trace, device, overrides, fault):
    """The fit loop in ``processes`` workers (``worker.py``), one card each;
    returns process 0's record with every process's fits under
    ``procs``."""
    n = cell.traffic["processes"]
    rundir = tempfile.mkdtemp(prefix="portbench-")
    try:
        with open(os.path.join(rundir, "spec.json"), "w") as f:
            json.dump({"workload": cell.name, "seed": seed, "seconds": seconds, "trace": trace,
                       "device": device.type, "overrides": overrides, "fault": fault,
                       "processes": n}, f)
        procs.run_workers(lambda port: [[sys.executable, WORKER, rundir, str(rank), str(port)]
                                        for rank in range(n)],
                          WORKER_DEADLINE, cwd=str(cells.ROOT))
        ranks = []
        for rank in range(n):
            with open(os.path.join(rundir, "rank{}.pkl".format(rank)), "rb") as f:
                ranks.append(pickle.load(f))  # written by our own workers
    finally:
        shutil.rmtree(rundir, ignore_errors=True)
    out = dict(ranks[0])
    out["procs"] = [r["records"] for r in ranks]
    out["peak"] = max(r["peak"] for r in ranks)
    out["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    if trace:
        out["trace"] = dict(ranks[0]["trace"],
                            busy_s=sum(r["trace"]["busy_s"] for r in ranks) / n)
    return out


def execute(cell, seed, seconds, trace, device, overrides=None, fault=None):
    """Set-up and window of one run of ``cell``: the loop's record."""
    loop = cell.traffic["loop"]
    if loop == "fit" and cell.traffic.get("processes", 1) > 1:
        return _fit_across_processes(cell, seed, seconds, trace, device, overrides, fault)
    if loop == "fit":
        return fitloop.run(cell, data.Seeds(seed), seconds, trace, device)
    if loop == "sweep":
        return sweeploop.run(cell, data.Seeds(seed), seconds, trace, device)
    raise ValueError("unknown loop {!r}".format(loop))


def compare(cell, res, seed, device, control=False):
    """The numbers compared (after the window), the control's in the
    program's place where ``control``."""
    seeds = data.Seeds(seed)
    if cell.traffic["loop"] == "fit":
        checks = {}
        if "procs" in res:   # the program's own results, before a control replaces them
            checks["procs_disagree"] = fitloop.disagreements(res["procs"])
        if control:
            fitloop.control_outputs(cell.config, res["records"], device)
        polish = fitloop.POLISH if "polish_gain" in cell.limits else 0
        return dict(fitloop.check(cell.config, res["records"], seeds, polish, device,
                                  descent="winner_above_start" in cell.limits,
                                  probe=res.get("probe")), **checks)
    if control:
        sweeploop.control_outputs(cell.config, res, cell.traffic["rank"], device)
    return sweeploop.check(cell.config, res, cell.traffic["rank"], device)


def result_line(cell, res, checks, started, trace):
    """The result's JSON object (``checks`` last)."""
    run = types.SimpleNamespace(cell=cell, records=res["records"],
                                procs=res.get("procs", [res["records"]]), trace=res["trace"])
    values = {}
    if trace:
        for m in cell.per_layer:
            values[m["name"]] = (cells.reader(m["name"])(run), m["unit"])
    else:
        for m in cell.end_to_end:
            v = res["opened"] - started if m["name"] == "setup_s" else res["rates"][m["name"]]
            values[m["name"]] = (v, m["unit"])
    if res["device"].type == "cuda":
        device = guard.device_info(cell.chips, res["peak"])
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()
                        if v is not None},
            "device": device}
    if trace:
        line["device"].update(busy_s=res["trace"]["busy_s"], window_s=res["trace"]["window_s"])
        line["breakdown"] = {"device_ops": res["trace"]["device_ops"],
                             "idle_gaps": res["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line


def run_cell(workload, seed, seconds, trace, started, device="cuda", overrides=None,
             fault=None, control=False, out=sys.stdout, err=sys.stderr):
    """One run; returns the exit code (the result line is printed to
    ``out``).  ``device="cpu"`` and ``overrides`` serve the tests (small
    sizes on the CPU); ``fault`` names a fault of ``faults.py`` that the
    workers of a cell across processes plant (in one process the caller
    plants it); ``control`` puts the control in the program's place."""
    import torch

    cell = cells.load(workload, overrides)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print("portbench: {} needs {} CUDA device(s); this machine has {}".format(
            workload, cell.chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=err)
        return 3
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    res = execute(cell, seed, seconds, trace, dev, overrides, fault)
    res["device"] = dev
    found = sorted(set(guard.forbidden_modules()) | set(res.get("forbidden", [])))
    if found:
        print("portbench: the run loaded {}".format(", ".join(found)), file=err)
        return 4
    # a value that is not finite is written as the largest float, so that
    # the line stays JSON
    checks = {k: {"value": float(np.nan_to_num(v, nan=sys.float_info.max)),
                  "limit": cell.limits[k]}
              for k, v in compare(cell, res, seed, dev, control).items()}
    line = result_line(cell, res, checks, started, trace)
    for k, c in checks.items():
        print("check {}: {} (limit {})".format(k, c["value"], c["limit"]), file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def main(argv, started):
    a = parse(argv)
    return run_cell(a.workload, a.seed, a.seconds, a.trace, started)
