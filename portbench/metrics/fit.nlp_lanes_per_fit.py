"""Objective lane-evaluations a fit makes: the program's counter
``gp.nlp_lanes`` (the lanes of each ``gp_nlp`` call: the race's stages and
any rescue; the refit's ``gp_fit`` is not counted), over the window and
averaged over its fits.  It repeats exactly on a seed.  A program without
the recorder (``mogp_tpu_torch.utils.metrics``) gives nothing to read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "counters"):
        return None
    lanes = metrics.counters().get("gp.nlp_lanes")
    return lanes / len(run.records) if lanes else None
