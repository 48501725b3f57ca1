"""Utility helpers: the port's copy of ``mogp_tpu/utils/misc.py``
(reference: ``mogp_emulator/utils.py:12-44``)."""

import numpy as np

__all__ = ["k_fold_cross_validation", "integer_bisect"]


def k_fold_cross_validation(X, K, randomise=False):
    """Generate K (training, validation) index partitions of ``X``.

    Reference: ``utils.py:12-30``.  Yields ``(train, validation)`` pairs
    where each partition element appears in exactly one validation set.
    """
    items = list(X)
    if randomise:
        items = list(np.random.permutation(len(items)))
        items = [list(X)[i] for i in items]
    for k in range(K):
        training = [x for i, x in enumerate(items) if i % K != k]
        validation = [x for i, x in enumerate(items) if i % K == k]
        yield training, validation


def integer_bisect(bound, f):
    """Find integers ``(a, b)`` with ``f(a) <= 0 < f(b)`` and ``b - a == 1``.

    Reference: ``utils.py:32-44``.  Assumes ``f(bound[0]) <= 0 < f(bound[1])``
    on entry; returns the bracketing pair.
    """
    lo, hi = int(bound[0]), int(bound[1])
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if f(mid) <= 0:
            lo = mid
        else:
            hi = mid
    return (lo, hi)
