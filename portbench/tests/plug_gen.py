"""A data generator that ``tiny.plug_tree`` lays into a benchmark tree of
its own as ``generators/plug_gen.py``: small and seeded, each call marked on
standard error so that a test sees the harness reach it."""

import sys

import numpy as np


def _f(x, data, seed):
    w = np.random.default_rng([seed, 1]).normal(size=(data["n_outputs"], x.shape[1]))
    return np.cos(2.0 * x @ w.T).T + x.sum(axis=1)


def problem(data, seed):
    print("plug_gen.problem", file=sys.stderr)
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(data["n_points"], data["n_dim"]))
    return x, _f(x, data, seed) + 0.01 * rng.randn(data["n_outputs"], data["n_points"])


def simulator(x, data, seed):
    print("plug_gen.simulator", file=sys.stderr)
    return _f(x, data, seed)
