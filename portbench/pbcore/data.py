"""Inputs of the cells, made from ``--seed``.

:class:`Seeds` splits one ``--seed`` (any whole number) into the streams a
run draws from, so that the same seed gives the same inputs and the same
sequence of restart seeds in every run and in every process.
:func:`problem` and :func:`simulator` call the data generator that the
configuration names (``portbench/generators/<name>.py``, ``cells.py``).
"""

import numpy as np

from . import cells


class Seeds:
    """The streams of one run: ``data`` (a 32-bit seed for the generators),
    :meth:`request` (the k-th request's 32-bit seed) and ``check`` (a
    ``Generator`` for the samples that the comparison with the reference
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


def problem(config, seed):
    """``(inputs, targets (outputs, n))`` of a configuration's ``data``."""
    return cells.generator(config).problem(config["data"], seed)


def simulator(config, x, seed):
    """The configuration's noiseless function of data seed ``seed`` at
    points ``x`` ``(m, D)``: ``(outputs, m)``."""
    return cells.generator(config).simulator(x, config["data"], seed)
