"""The ``large_n`` data generator: the problem of
``benchmarks/benchmark_large_n.py:34-39``, copied so that the yardstick does
not move when the original does.

``data``: ``n_points``, ``n_dim`` (one output).
"""

import numpy as np


def problem(data, seed):
    """Inputs ``(n_points, n_dim)`` in the unit cube and the target
    ``sin(4 x0) cos(2 x1) + sum_{i >= 2} x_i`` ``(1, n_points)``."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(data["n_points"], data["n_dim"]))
    return x, simulator(x, data, seed)


def simulator(x, data, seed):
    """The target at points ``x`` ``(m, n_dim)``: ``(1, m)`` (it has no
    noise, so the seed does not enter)."""
    return (np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(axis=1))[None, :]
