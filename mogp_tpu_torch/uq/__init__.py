"""UQ toolchain: experimental design, history matching, SMC, validation.

Port of ``mogp_tpu/uq``.  Sequential design (MICE) and gKDR are not
ported yet (ROADMAP A6-A7).
"""

from .experimental_design import (
    ExperimentalDesign,
    LatinHypercubeDesign,
    MaxiMinLHC,
    MonteCarloDesign,
)
from .history_matching import HistoryMatching
from .smc import SMCResult, smc_history_match, systematic_resample
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
    "SMCResult",
    "smc_history_match",
    "systematic_resample",
    "Errors",
    "PivotErrors",
    "StandardErrors",
    "compute_errors",
    "generate_mahal_dist",
    "mahalanobis",
    "pivoted_errors",
    "standard_errors",
]
