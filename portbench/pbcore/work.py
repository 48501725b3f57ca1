"""The work of a cell, counted from its shapes, and the card's peaks.

A count is of what the algorithm needs, not of what a kernel happens to do:
a later PR that does less work for the same answer reads a higher share,
and one that counts more than the work cannot read above 100%.
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def predict_flops(n, D, outputs):
    """Floating-point operations of one query point's prediction and
    implausibility over every output of emulators trained on ``n`` points
    in ``D`` inputs: ``n (3D + 2)`` for the cross-covariance (the scaled
    difference, its square and sum, the exponential and the scale), ``n^2``
    for the triangular substitution, ``4n`` for the mean and ``|v|^2``."""
    return outputs * (n * (3 * D + 2) + n * n + 4 * n)


def predict_bytes(D, k, itemsize=4):
    """Bytes of one query point: its coordinates read once and its ``k``
    implausibilities written once."""
    return (D + k) * itemsize


def least_seconds(flops, n_bytes, dtype="float32"):
    """The least time the card could take: the larger of the operations
    over the peak of their precision and the bytes over the memory rate."""
    return max(flops / PEAKS["flops_per_s"][dtype], n_bytes / PEAKS["bytes_per_s"])
