"""The readings that a cell's limits are set from (not part of a benchmark run).

    python3 portbench/control.py --workload W --seconds T --seeds 1,2,3 --mode MODE

Runs the cell once for each seed, in this one process, and prints each
run's result line, whose ``checks`` hold the numbers compared:

* ``--mode sound``: the program as it is (the lower readings);
* ``--mode control``: the control in the program's place, the plain
  reference that the configuration names in TF32 (``pbcore/cells.py``:
  float32 with TF32 products, the next precision below the
  configuration's float32; its upper readings);
* ``--mode <fault>``: the program with a fault of ``pbcore/faults.py``
  planted under the timed path.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(os.path.dirname(BENCH), "build", "portbench_cache", sub)


def main(argv):
    from pbcore import cells, cli, faults

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--mode", default="sound", choices=["sound", "control", *faults.FAULTS])
    a = p.parse_args(argv)
    across = cells.load(a.workload).traffic.get("processes", 1) > 1
    fault = a.mode if a.mode in faults.FAULTS else None
    if fault and not across:
        faults.FAULTS[fault]()
    code = 0
    started = STARTED
    for seed in (int(s) for s in a.seeds.split(",")):
        print("mode {} seed {}".format(a.mode, seed), flush=True)
        code |= cli.run_cell(a.workload, seed, a.seconds, 0, started,
                             fault=fault if across else None, control=a.mode == "control")
        started = time.time()
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
