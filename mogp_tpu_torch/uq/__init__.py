"""UQ toolchain: experimental design, history matching, validation.

Port of ``mogp_tpu/uq``.  Sequential design (MICE), gKDR and SMC are not
ported yet (ROADMAP A6-A8).
"""

from .experimental_design import (
    ExperimentalDesign,
    LatinHypercubeDesign,
    MaxiMinLHC,
    MonteCarloDesign,
)
from .history_matching import HistoryMatching
from .validation import (
    Errors,
    PivotErrors,
    StandardErrors,
    compute_errors,
    generate_mahal_dist,
    mahalanobis,
    pivoted_errors,
    standard_errors,
)

__all__ = [
    "ExperimentalDesign",
    "LatinHypercubeDesign",
    "MaxiMinLHC",
    "MonteCarloDesign",
    "HistoryMatching",
    "Errors",
    "PivotErrors",
    "StandardErrors",
    "compute_errors",
    "generate_mahal_dist",
    "mahalanobis",
    "pivoted_errors",
    "standard_errors",
]
