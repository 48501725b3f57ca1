"""The ``tsunami_trend`` data generator: the synthetic tsunami-shaped targets
of ``generators/tsunami.py`` (``bench.py:67-77``) plus a seeded linear trend
per output, so that a linear mean carries real signal.

Output ``j`` adds ``a_j + x @ b_j``, with ``a_j`` and every entry of
``b_j`` standard normal, drawn from a stream of the seed that the tsunami
part does not read: at the same seed the inputs, the tsunami part and its
noise are those of ``generators/tsunami.py``.

``data``: ``n_points``, ``n_dim``, ``n_outputs``.
"""

import numpy as np


def _tsunami(x, data, rng):
    """The tsunami part at ``x`` ``(m, D)`` without noise, ``(m, outputs)``,
    from ``rng`` positioned after the inputs' draw."""
    w = rng.randn(data["n_outputs"], x.shape[1])
    phase = rng.uniform(0, 2 * np.pi, size=data["n_outputs"])
    return np.sin(x @ w.T + phase) + 0.3 * (x**2) @ np.abs(w).T


def _trend(x, data, seed):
    """``a_j + x @ b_j`` at ``x``, ``(m, outputs)``."""
    rng = np.random.default_rng([seed, 2])
    a = rng.standard_normal(data["n_outputs"])
    b = rng.standard_normal((x.shape[1], data["n_outputs"]))
    return a + x @ b


def problem(data, seed):
    """Inputs ``(n_points, n_dim)`` in the unit cube and targets
    ``(n_outputs, n_points)``: the tsunami targets, their noise, the trend."""
    rng = np.random.RandomState(seed)
    inputs = rng.uniform(0.0, 1.0, size=(data["n_points"], data["n_dim"]))
    targets = _tsunami(inputs, data, rng) + 0.01 * rng.randn(data["n_points"], data["n_outputs"])
    return inputs, (targets + _trend(inputs, data, seed)).T.copy()


def simulator(x, data, seed):
    """The function of :func:`problem` of the same seed, without its noise,
    at points ``x`` ``(m, n_dim)``: ``(n_outputs, m)``."""
    rng = np.random.RandomState(seed)
    rng.uniform(0.0, 1.0, size=(data["n_points"], x.shape[1]))  # problem's inputs
    return (_tsunami(x, data, rng) + _trend(x, data, seed)).T.copy()
