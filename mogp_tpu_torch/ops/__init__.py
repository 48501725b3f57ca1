"""Core math ops: kernels, factorizations, transforms.

The fused kernel-matrix build is the submodule ``ops.kernel_matrix``; it
is not re-exported here, so that the module (with its ``launches``
counter) and not its function answers to that name.
"""

from .cholesky import ChoFactor, cholesky_factor, fixed_cholesky, jit_cholesky
from .kernels import (
    KernelBase,
    Matern52,
    ProductMat52,
    SquaredExponential,
    UniformMat52,
    UniformSqExp,
    get_kernel,
)
from .linalg import MarginalCore, marginal_core, marginal_nlp
from .transforms import CorrTransform, CovTransform

__all__ = [
    "ChoFactor",
    "cholesky_factor",
    "fixed_cholesky",
    "jit_cholesky",
    "KernelBase",
    "Matern52",
    "ProductMat52",
    "SquaredExponential",
    "UniformMat52",
    "UniformSqExp",
    "get_kernel",
    "MarginalCore",
    "marginal_core",
    "marginal_nlp",
    "CorrTransform",
    "CovTransform",
]
