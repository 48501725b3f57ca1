"""Runs of a cell at a small size on the CPU, each in a fresh interpreter
(a planted fault replaces functions of the program for good)."""

import json
import subprocess
import sys

from pbcore import cells

# small sizes of each configuration and traffic, in float64
SMALL = {
    "tsunami64": {"data": {"generator": "tsunami", "n_points": 30, "n_dim": 4, "n_outputs": 4},
                  "fit": {"n_tries": 4, "maxiter": 20, "refit": True}},
    "large_n4096": {"data": {"generator": "large_n", "n_points": 60, "n_dim": 3,
                             "n_outputs": 1}},
}
TRAFFIC = {"sweep": {"pool_points": 3000, "check_points_per_wave": 256}}

CODE = """
import json, sys, time
sys.path[:0] = [{root!r}, {bench!r}]
from pbcore import cli, faults
fault, control, workload, overrides = {fault!r}, {control!r}, {workload!r}, json.loads({ov!r})
across = {across!r}
if fault and not across:
    faults.FAULTS[fault]()
sys.exit(cli.run_cell(workload, {seed}, {seconds}, {trace}, time.time(), device="cpu",
                      overrides=overrides, fault=fault if across else None, control=control))
"""


def overrides(workload):
    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in manifest["workloads"] if w["name"] == workload)
    cell = cells.load(workload)
    model = dict(cell.config["model"], dtype="float64")
    out = {"config": dict(SMALL[w["config"]], model=model)}
    if w["traffic"] in TRAFFIC:
        out["traffic"] = TRAFFIC[w["traffic"]]
    return out, cell.traffic.get("processes", 1) > 1


def run(workload, fault=None, control=False, seed=2**31 + 17, seconds=1.0, trace=0):
    """The result line of one small run (``None`` where it printed none)
    and its exit code."""
    ov, across = overrides(workload)
    code = CODE.format(root=str(cells.ROOT), bench=str(cells.BENCH), fault=fault,
                       control=control, workload=workload, ov=json.dumps(ov), across=across,
                       seed=seed, seconds=seconds, trace=trace)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=str(cells.ROOT))
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    return (json.loads(lines[-1]) if lines else None), p.returncode, p.stderr
