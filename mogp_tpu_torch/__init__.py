"""mogp_tpu_torch: the PyTorch and CUDA port of ``mogp_tpu``.

Same module layout and public names as ``mogp_tpu``; tensors carry an
explicit leading lanes (outputs) axis where the JAX package used ``vmap``,
constructors take an explicit ``device=`` and ``dtype=``, and the fused
prediction (the kernel-matrix build with its consumers), the kernel-matrix
build of the other prediction paths and the Cholesky factorizations are
CUDA kernels (``csrc/kernel_matrix.cu``, ``csrc/cholesky_batched.cu``,
``csrc/cholesky_blocked.cu``).  This package never imports ``jax``.

Ported so far: the serving path -- construct ``GaussianProcess`` /
``MultiOutputGP``, ``fit`` at given hyperparameters, ``predict`` -- the
MAP fit (``fit_GP_MAP``, batched L-BFGS over outputs x restarts, with the
race schedule), and ``.npz`` checkpoints.  The UQ toolchain comes later.
"""

__version__ = "0.1.0"

# module-style aliases matching the reference package layout
from .models import priors as Priors
from .ops import kernels as Kernel

from .models.fitting import fit_GP_MAP
from .models.gp import GaussianProcess, PredictResult
from .models.mogp import MultiOutputGP
from .models.params import GPParams
from .models.priors import (
    GPPriors,
    GammaPrior,
    InvGammaPrior,
    LogNormalPrior,
    MeanPriors,
    NormalPrior,
    WeakPrior,
)
from .utils.checkpoint import load_gp, load_mogp

__all__ = [
    "Kernel",
    "Priors",
    "GaussianProcess",
    "PredictResult",
    "MultiOutputGP",
    "fit_GP_MAP",
    "GPParams",
    "GPPriors",
    "GammaPrior",
    "InvGammaPrior",
    "LogNormalPrior",
    "MeanPriors",
    "NormalPrior",
    "WeakPrior",
    "load_gp",
    "load_mogp",
]
