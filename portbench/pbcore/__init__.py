"""The harness of the port's benchmark (``BENCHMARK.json`` at the root)."""
