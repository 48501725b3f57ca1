"""Matrices a fit factors: the program's counter ``chol.matrices``, added
in ``ops/cholesky.py::_factor`` above the choice of kernel (K2 or the
blocked route), so that a new kernel leaves it as it is; every jitter
candidate counts.  Over the window, averaged over its fits; it repeats
exactly on a seed.  A program without the recorder
(``mogp_tpu_torch.utils.metrics``) gives nothing to read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "counters"):
        return None
    matrices = metrics.counters().get("chol.matrices")
    return matrices / len(run.records) if matrices else None
