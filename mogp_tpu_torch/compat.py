"""Drop-in compatibility aliases for mogp-emulator code.

Port of ``mogp_tpu/compat.py``.  The reference ships device-specific
classes (``GaussianProcessGPU``, ``MultiOutputGP_GPU``; soft-import gate
``LibGPGPU.gpu_usable()``) beside the CPU classes.  Here the standard
classes already run on the card (their default device), so the
device-specific names alias them, and :func:`gpu_usable` asks torch
whether there is a CUDA device.

Usage for code being migrated from the reference::

    from mogp_tpu_torch.compat import GaussianProcessGPU, gpu_usable

    if gpu_usable():                      # is there a CUDA device?
        gp = GaussianProcessGPU(x, y)     # same object as GaussianProcess
"""

import torch

from .models.gp import GaussianProcess
from .models.mogp import MultiOutputGP
from .ops.kernels import KernelBase, mat52, sqexp

__all__ = [
    "GaussianProcessGPU",
    "MultiOutputGP_GPU",
    "GPUUnavailableError",
    "gpu_usable",
    "StationaryKernel",
    "UniformKernel",
    "ProductKernel",
    "SqExpBase",
    "Mat52Base",
]

# kernel base-class aliases for reference imports
# (``from mogp_emulator.Kernel import StationaryKernel`` etc.); the
# reference's mixin hierarchy collapses to configuration fields here.
StationaryKernel = KernelBase
UniformKernel = KernelBase
ProductKernel = KernelBase


class SqExpBase:
    """Function-base alias (``Kernel.py:765``)."""

    calc_K = staticmethod(sqexp)


class Mat52Base:
    """Function-base alias (``Kernel.py:853``)."""

    calc_K = staticmethod(mat52)


class GPUUnavailableError(RuntimeError):
    """Raised by reference code when no GPU is available
    (``GaussianProcessGPU.py:24``); kept for except clauses.  The port
    raises ``RuntimeError`` from ``config.resolve_device`` instead."""


# the standard classes run on the card by default
GaussianProcessGPU = GaussianProcess
MultiOutputGP_GPU = MultiOutputGP


def gpu_usable():
    """Whether a CUDA device is available (the analogue of
    ``LibGPGPU.gpu_usable``, ``LibGPGPU.py:13``)."""
    return torch.cuda.is_available()
