"""mogp_tpu_torch: the PyTorch and CUDA port of ``mogp_tpu``.

Same module layout and public names as ``mogp_tpu``; tensors carry an
explicit leading lanes (outputs) axis where the JAX package used ``vmap``,
constructors take an explicit ``device=`` and ``dtype=``, and the fused
prediction (the kernel-matrix build with its consumers), the kernel-matrix
build of the other prediction paths and the Cholesky factorizations are
CUDA kernels (``csrc/kernel_matrix.cu``, ``csrc/cholesky_batched.cu``,
``csrc/cholesky_blocked.cu``).  This package never imports ``jax``.

Ported so far: the serving path -- construct ``GaussianProcess`` /
``MultiOutputGP`` (every nugget type, ``"pivot"`` included), ``fit`` at
given hyperparameters, ``predict`` -- the MAP fit (``fit_GP_MAP``, batched
L-BFGS over outputs x restarts, with the race schedule), ``.npz``
checkpoints, ``MeanFunction``, and the UQ workflow's one-shot designs
(``MonteCarloDesign``, ``LatinHypercubeDesign``, ``MaxiMinLHC``), history
matching (``HistoryMatching``, whose large sweeps run on the card through
the fused prediction kernel), ``validation``, and inference over the
hyperparameters: batched NUTS (``sample_GP_MCMC``, ``sample_MOGP_MCMC``),
``fit_GP_VI``, ``predict_MCMC`` and SMC history matching
(``smc_history_match``), with their checkpoints, and sequential design
(``SequentialDesign``, ``MICEDesign``, ``MICEFastGP`` and the fixed-shape
``DeviceMICEDesign``), gKDR (``gKDR``), the kernel derivatives
(``KernelBase.kernel_deriv`` / ``kernel_hessian``) and the multi-device
layer (``parallel``: ``DeviceMesh``, ``auto_mesh`` and the ``mesh=``
argument of ``fit_GP_MAP``, ``HistoryMatching``, ``sample_GP_MCMC``,
``sample_MOGP_MCMC``, ``smc_history_match`` and ``DeviceMICEDesign``).
"""

__version__ = "0.1.0"

# module-style aliases matching the reference package layout
from .models import priors as Priors
from .ops import kernels as Kernel

from .models.fitting import fit_GP_MAP
from .models.gp import GaussianProcess, PredictResult
from .models.inference import fit_GP_VI, predict_MCMC, sample_GP_MCMC, sample_MOGP_MCMC
from .models.meanfunction import MeanFunction
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
from .uq import validation
from .uq.dimension_reduction import gKDR
from .uq.experimental_design import (
    ExperimentalDesign,
    LatinHypercubeDesign,
    MaxiMinLHC,
    MonteCarloDesign,
)
from .uq.history_matching import HistoryMatching
from .uq.mice_device import DeviceMICEDesign
from .uq.sequential_design import MICEDesign, MICEFastGP, SequentialDesign
from .uq.smc import smc_history_match
from .utils.checkpoint import load_gp, load_mogp

__all__ = [
    "ExperimentalDesign",
    "MonteCarloDesign",
    "LatinHypercubeDesign",
    "MaxiMinLHC",
    "HistoryMatching",
    "SequentialDesign",
    "MICEDesign",
    "MICEFastGP",
    "DeviceMICEDesign",
    "gKDR",
    "validation",
    "MeanFunction",
    "Kernel",
    "Priors",
    "GaussianProcess",
    "PredictResult",
    "MultiOutputGP",
    "fit_GP_MAP",
    "sample_GP_MCMC",
    "sample_MOGP_MCMC",
    "predict_MCMC",
    "fit_GP_VI",
    "smc_history_match",
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
