"""The small size of each configuration that was added by files alone, laid
into ``tiny.SMALL`` before any test of ``portbench/tests`` is collected, so
that the harness's generic tests (``test_portbench_traffic.py``,
``test_portbench_spans.py``) run its cells whichever files are collected."""

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH), BENCH, os.path.join(BENCH, "tests")]

import tiny  # noqa: E402

tiny.SMALL.setdefault("ukriging64", {
    "data": {"generator": "tsunami_trend", "n_points": 40, "n_dim": 14, "n_outputs": 8},
    "fit": {"n_tries": 4, "maxiter": 20, "refit": True}})
