"""Utilities: checkpoints; timing, FLOP counts and profiling in ``utils.metrics``."""

from .checkpoint import atomic_savez, load_gp, load_mogp, save_gp, save_mogp

__all__ = ["atomic_savez", "save_gp", "load_gp", "save_mogp", "load_mogp"]
