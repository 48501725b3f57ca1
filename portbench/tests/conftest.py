"""The harness's own tests, on the CPU: ``python3 -m pytest portbench/tests``.

A test that needs a card decides inside its fixture and skips."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]
