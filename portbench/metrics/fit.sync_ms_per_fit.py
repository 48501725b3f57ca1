"""Milliseconds a fit's host spends blocked on the device at the lockstep
L-BFGS's flags: the program's span ``lbfgs.sync`` (each ``bool(running.any())``
and ``bool(searching.any())`` of ``ops/lbfgs.py``), summed over the window
and averaged over its fits.  A program without the recorder
(``mogp_tpu_torch.utils.metrics``) gives nothing to read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "spans"):
        return None
    seconds = [s.seconds for s in metrics.spans() if s.name == "lbfgs.sync"]
    return 1e3 * sum(seconds) / len(run.records) if seconds else None
