"""The ``tsunami`` data generator: the synthetic tsunami-shaped targets of
``bench.py:67-77`` (``chip_smoke.py::make_data`` and ``simulator``), copied
so that the yardstick does not move when the originals do.

``data``: ``n_points``, ``n_dim``, ``n_outputs``.
"""

import numpy as np


def problem(data, seed):
    """Inputs ``(n_points, n_dim)`` in the unit cube and targets
    ``(n_outputs, n_points)``."""
    rng = np.random.RandomState(seed)
    inputs = rng.uniform(0.0, 1.0, size=(data["n_points"], data["n_dim"]))
    w = rng.randn(data["n_outputs"], data["n_dim"])
    phase = rng.uniform(0, 2 * np.pi, size=data["n_outputs"])
    targets = (
        np.sin(inputs @ w.T + phase)
        + 0.3 * (inputs**2) @ np.abs(w).T
        + 0.01 * rng.randn(data["n_points"], data["n_outputs"])
    )
    return inputs, targets.T.copy()


def simulator(x, data, seed):
    """The function of :func:`problem` of the same seed, without its noise,
    at points ``x`` ``(m, n_dim)``: ``(n_outputs, m)``."""
    rng = np.random.RandomState(seed)
    rng.uniform(0.0, 1.0, size=(data["n_points"], x.shape[1]))  # problem's inputs
    w = rng.randn(data["n_outputs"], x.shape[1])
    phase = rng.uniform(0, 2 * np.pi, size=data["n_outputs"])
    return (np.sin(x @ w.T + phase) + 0.3 * (x**2) @ np.abs(w).T).T.copy()
