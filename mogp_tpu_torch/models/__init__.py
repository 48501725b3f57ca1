"""Model layer: GP core, multi-output GP, MAP fitting, parameters, priors,
mean functions."""

from .gp import (
    FitArtifacts,
    GPData,
    GaussianProcess,
    GaussianProcessBase,
    PredictResult,
    gp_fit,
    gp_nlp,
    gp_predict,
    gp_predict_tiled,
    make_gp_data,
)
from .fitting import fit_GP_MAP
from .meanfun import design_matrix, design_matrix_fn, parse_formula
from .meanfunction import MeanFunction
from .mogp import MultiOutputGP
from .params import GPParams
from .priors import (
    GPPriors,
    GammaPrior,
    InvGammaPrior,
    LogNormalPrior,
    MeanPriors,
    NormalPrior,
    PriorDist,
    WeakPrior,
    max_spacing,
    min_spacing,
)

__all__ = [
    "FitArtifacts",
    "GPData",
    "GaussianProcess",
    "GaussianProcessBase",
    "PredictResult",
    "gp_fit",
    "gp_nlp",
    "gp_predict",
    "gp_predict_tiled",
    "make_gp_data",
    "fit_GP_MAP",
    "design_matrix",
    "design_matrix_fn",
    "parse_formula",
    "MeanFunction",
    "MultiOutputGP",
    "GPParams",
    "GPPriors",
    "GammaPrior",
    "InvGammaPrior",
    "LogNormalPrior",
    "MeanPriors",
    "NormalPrior",
    "PriorDist",
    "WeakPrior",
    "max_spacing",
    "min_spacing",
]
