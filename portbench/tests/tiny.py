"""Runs of a cell at a small size on the CPU, each in a fresh interpreter
(a planted fault replaces functions of the program for good), and a
benchmark tree of its own for a configuration added by files alone."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

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
import json, pathlib, sys, time
sys.path[:0] = [{root!r}, {bench!r}]
from pbcore import cells, cli, faults
fault, control, workload, overrides = {fault!r}, {control!r}, {workload!r}, json.loads({ov!r})
across, tree = {across!r}, {tree!r}
if tree:
    cells.ROOT = pathlib.Path(tree)
    cells.BENCH = cells.ROOT / "portbench"
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


def run(workload, fault=None, control=False, seed=2**31 + 17, seconds=1.0, trace=0,
        tree=None):
    """The result line of one small run (``None`` where it printed none),
    its exit code and its standard error; ``tree``: the root of a
    benchmark tree of its own (:func:`plug_tree`), whose files are taken as
    they are."""
    ov, across = overrides(workload) if tree is None else ({}, False)
    code = CODE.format(root=str(cells.ROOT), bench=str(cells.BENCH), fault=fault,
                       control=control, workload=workload, ov=json.dumps(ov), across=across,
                       seed=seed, seconds=seconds, trace=trace,
                       tree=None if tree is None else str(tree))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=str(cells.ROOT))
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    return (json.loads(lines[-1]) if lines else None), p.returncode, p.stderr


# a configuration added by files alone: its file, its generator and its
# reference (modules of this directory, which exist nowhere else), its
# traffic and limits, at a small size in float64
HERE = Path(__file__).resolve().parent
PLUG = {
    "name": "plug",
    "data": {"generator": "plug_gen", "n_points": 30, "n_dim": 3, "n_outputs": 3},
    "reference": "plug_ref",
    "model": {"class": "MultiOutputGP", "kernel": "SquaredExponential", "mean": "zero",
              "nugget": "adaptive", "dtype": "float64"},
    "fit": {"n_tries": 4, "maxiter": 20, "refit": True},
    "reduced": [],
}
PLUG_TRAFFIC = {
    "plug_fit": {"loop": "fit", "processes": 1},
    "plug_sweep": {"loop": "sweep", "pool_points": 3000, "rank": 1, "obs_var": [0.01, 0.05],
                   "check_points_per_wave": 256},
}
PLUG_LIMITS = {
    "plug.fit": {"unfit": 0, "nugget_off_ladder": 0, "unmoved": 0, "nlp_gap": 0.001,
                 "polish_gain": 1.0, "winner_above_start": 0.0, "starts_off": 0},
    "plug.sweep": {"wrong_count": 0, "nugget_off_ladder": 0, "I_gap": 0.002},
}


def plug_tree(root):
    """Write under ``root`` a benchmark tree that holds the configuration
    ``plug`` and its cells ``plug.fit`` and ``plug.sweep``, and nothing of the
    default generators or reference, so that a run that reached them would
    fail."""
    bench = Path(root) / "portbench"
    for d in ("configs", "traffic", "limits", "generators", "reference"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "plug.json").write_text(json.dumps(PLUG))
    for name, entry in PLUG_TRAFFIC.items():
        (bench / "traffic" / "{}.json".format(name)).write_text(json.dumps(entry))
    for name, entry in PLUG_LIMITS.items():
        (bench / "limits" / "{}.json".format(name)).write_text(json.dumps({"limits": entry}))
    shutil.copy(HERE / "plug_gen.py", bench / "generators")
    shutil.copy(HERE / "plug_ref.py", bench / "reference")
    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "plug", "source": "portbench/tests/tiny.py",
                            "file": "portbench/configs/plug.json", "reduced": [],
                            "why": "a configuration added by files alone"}]
    manifest["workloads"] = [
        {"name": "plug." + loop, "config": "plug", "traffic": "plug_" + loop, "chips": 1,
         "why": "the {} loop over a generator and a reference of its own".format(loop)}
        for loop in ("fit", "sweep")]
    rates = {"fits_per_s": ["plug.fit"], "query_points_per_s": ["plug.sweep"]}
    for m in manifest["end_to_end"]:
        if m["name"] in rates:
            m["workloads"] = rates[m["name"]]
    manifest["per_layer"] = []
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(manifest))
    return Path(root)
