"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload tsunami64.fit --seed 7 --seconds 20 --trace 0

Run from the root of a checkout that holds ``mogp_tpu_torch``, on a machine
with the cards the cell asks for.  See ``pbcore/cli.py`` for the result
line.
"""

import time

STARTED = time.time()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH]

# every build and kernel cache of a run stays at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)

if __name__ == "__main__":
    from pbcore import cli

    sys.exit(cli.main(sys.argv[1:], STARTED))
