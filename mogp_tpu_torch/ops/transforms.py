"""Hyperparameter coordinate transforms (port of ``mogp_tpu/ops/transforms.py``).

The raw vector ``theta`` maps to the interpretable values:

* correlation length ``l = exp(-theta/2)``;
* covariance / nugget ``sigma2 = exp(theta)``.

Tensors go through ``torch`` and everything else through numpy, so host
callers (parameter views) never touch a device.
"""

import numpy as np
import torch

__all__ = ["CorrTransform", "CovTransform"]


def _xp(x):
    """numpy for host values, torch for tensors."""
    return torch if isinstance(x, torch.Tensor) else np


class CorrTransform:
    """raw <-> correlation length: ``l = exp(-0.5 * theta)``."""

    @staticmethod
    def transform(raw):
        return _xp(raw).exp(-0.5 * raw)

    @staticmethod
    def inv_transform(scaled):
        return -2.0 * _xp(scaled).log(scaled)


class CovTransform:
    """raw <-> covariance / nugget: ``sigma2 = exp(theta)``."""

    @staticmethod
    def transform(raw):
        return _xp(raw).exp(raw)

    @staticmethod
    def inv_transform(scaled):
        return _xp(scaled).log(scaled)
