"""UQ toolchain: experimental design, history matching, SMC, validation,
sequential design (MICE), gKDR.

Port of ``mogp_tpu/uq``.
"""

from .dimension_reduction import gKDR, gram_matrix, gram_matrix_sqexp, median_dist
from .experimental_design import (
    ExperimentalDesign,
    LatinHypercubeDesign,
    MaxiMinLHC,
    MonteCarloDesign,
)
from .history_matching import HistoryMatching
from .mice_device import DeviceMICEDesign
from .sequential_design import MICEDesign, MICEFastGP, SequentialDesign
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
    "gKDR",
    "gram_matrix",
    "gram_matrix_sqexp",
    "median_dist",
    "ExperimentalDesign",
    "LatinHypercubeDesign",
    "MaxiMinLHC",
    "MonteCarloDesign",
    "HistoryMatching",
    "SequentialDesign",
    "MICEDesign",
    "MICEFastGP",
    "DeviceMICEDesign",
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
