"""Inputs of the cells, made from ``--seed``.

The generators are copies, so that the yardstick does not move when the
originals do:

* :func:`tsunami_data` and :func:`tsunami_simulator` are the synthetic
  tsunami-shaped targets of ``bench.py:67-77`` (``chip_smoke.py::make_data``
  and ``simulator``);
* :func:`tsunami_thetas` is ``chip_smoke.py::make_thetas``;
* :func:`large_n_data` is ``benchmarks/benchmark_large_n.py:34-39``.

:class:`Seeds` splits one ``--seed`` (any whole number) into the streams a
run draws from, so that the same seed gives the same inputs and the same
sequence of restart seeds in every run and in every process.
"""

import numpy as np


class Seeds:
    """The streams of one run: ``data`` (a 32-bit seed for the generators
    above), :meth:`request` (the k-th request's 32-bit seed) and ``check``
    (a ``Generator`` for the samples that the comparison with the reference
    draws)."""

    def __init__(self, seed):
        data, requests, check = np.random.SeedSequence(int(seed) % 2**64).spawn(3)
        self.data = int(data.generate_state(1)[0])
        self._requests = requests
        self._cache = np.zeros(0, dtype=np.uint32)
        self.check = np.random.default_rng(check)

    def request(self, k):
        """The 32-bit seed of request ``k`` (0 is the warm-up's)."""
        if k >= len(self._cache):
            self._cache = self._requests.generate_state(2 * k + 64)
        return int(self._cache[k])


def tsunami_data(n_points, n_dim, n_outputs, seed):
    """Inputs ``(n_points, n_dim)`` in the unit cube and targets
    ``(n_outputs, n_points)``."""
    rng = np.random.RandomState(seed)
    inputs = rng.uniform(0.0, 1.0, size=(n_points, n_dim))
    w = rng.randn(n_outputs, n_dim)
    phase = rng.uniform(0, 2 * np.pi, size=n_outputs)
    targets = (
        np.sin(inputs @ w.T + phase)
        + 0.3 * (inputs**2) @ np.abs(w).T
        + 0.01 * rng.randn(n_points, n_outputs)
    )
    return inputs, targets.T.copy()


def tsunami_simulator(x, n_points, n_outputs, seed):
    """The function of :func:`tsunami_data` of the same seed, without its
    noise, at points ``x`` ``(m, n_dim)``: ``(n_outputs, m)``."""
    rng = np.random.RandomState(seed)
    rng.uniform(0.0, 1.0, size=(n_points, x.shape[1]))  # tsunami_data's inputs
    w = rng.randn(n_outputs, x.shape[1])
    phase = rng.uniform(0, 2 * np.pi, size=n_outputs)
    return (np.sin(x @ w.T + phase) + 0.3 * (x**2) @ np.abs(w).T).T.copy()


def tsunami_thetas(n_outputs, n_dim, seed):
    """Raw hyperparameters ``(n_outputs, n_dim + 1)``: correlation raws in
    U(-1, 1), covariance raw in U(-0.5, 0.5)."""
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(-1, 1, size=(n_outputs, n_dim)),
         rng.uniform(-0.5, 0.5, size=(n_outputs, 1))],
        axis=1,
    )


def large_n_data(n, n_dim, seed):
    """Inputs ``(n, n_dim)`` in the unit cube and the target
    ``sin(4 x0) cos(2 x1) + sum_{i >= 2} x_i`` ``(1, n)``."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(n, n_dim))
    y = np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(axis=1)
    return x, y[None, :]


def problem(config, seed):
    """``(inputs, targets (outputs, n))`` of a configuration's ``data``."""
    d = config["data"]
    if d["generator"] == "tsunami":
        return tsunami_data(d["n_points"], d["n_dim"], d["n_outputs"], seed)
    if d["generator"] == "large_n":
        return large_n_data(d["n_points"], d["n_dim"], seed)
    raise ValueError("unknown data generator {!r}".format(d["generator"]))
