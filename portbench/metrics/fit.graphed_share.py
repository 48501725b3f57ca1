"""The share of a fit's objective evaluations that ran from CUDA graphs:
the program's counter ``lbfgs.evals_graphed`` over it plus
``lbfgs.evals_eager`` (``ops/lbfgs.py``: the lanes of each value and
gradient of the lockstep L-BFGS, replayed or enqueued eagerly), over the
window.  1 where every stage replays the graphs that set-up captured, 0
where the fit runs eagerly (the blocked route).  A program without those
counters gives nothing to read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "counters"):
        return None
    counters = metrics.counters()
    graphed = counters.get("lbfgs.evals_graphed", 0)
    evals = graphed + counters.get("lbfgs.evals_eager", 0)
    return graphed / evals if evals else None
