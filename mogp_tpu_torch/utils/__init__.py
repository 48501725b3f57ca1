"""Utilities: checkpoints; ``k_fold_cross_validation`` and ``integer_bisect``
in ``utils.misc``; timing, FLOP counts, profiling and the program's
recorder of spans and counters in ``utils.metrics``."""

from .checkpoint import atomic_savez, load_gp, load_mogp, save_gp, save_mogp
from .misc import integer_bisect, k_fold_cross_validation

__all__ = ["atomic_savez", "save_gp", "load_gp", "save_mogp", "load_mogp",
           "k_fold_cross_validation", "integer_bisect"]
