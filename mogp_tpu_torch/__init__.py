"""mogp_tpu_torch: the PyTorch and CUDA port of ``mogp_tpu``.

Same module layout and public names as ``mogp_tpu``; tensors carry an
explicit leading lanes (outputs) axis where the JAX package used ``vmap``,
constructors take an explicit ``device=`` and ``dtype=``, and the fused
kernel-matrix build of the prediction path is a CUDA kernel
(``csrc/kernel_matrix.cu``).  This package never imports ``jax``.

Ported so far: the serving path -- construct ``GaussianProcess`` /
``MultiOutputGP``, ``fit`` at given hyperparameters, ``predict`` -- and
``.npz`` checkpoints.  MAP fitting and the UQ toolchain come later.
"""

__version__ = "0.1.0"

# module-style aliases matching the reference package layout
from .models import priors as Priors
from .ops import kernels as Kernel

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
