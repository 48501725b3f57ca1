"""Core math ops: kernels, factorizations, transforms, the optimizer.

The CUDA kernels' wrappers are the submodules ``ops.kernel_matrix`` (K1),
``ops.predict_fused`` (K1 redesigned as the fused prediction, and its
route), ``ops.cholesky_batched`` (K2, and the route by size) and
``ops.cholesky_blocked`` (K3-K5); they are not re-exported here, so that
each module (with its ``launches`` counter) and not its function answers
to that name.  The batched L-BFGS is ``ops.lbfgs``.
"""

from .cholesky import (
    ChoFactor,
    PivotedChoFactor,
    cholesky_factor,
    fixed_cholesky,
    jit_cholesky,
    pivoted_cholesky,
)
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
    "PivotedChoFactor",
    "pivoted_cholesky",
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
