"""Milliseconds of a fit outside its optimization and refit: each root
span ``fitting.fit_GP_MAP`` less its children ``fitting.stage``,
``fitting.rescue`` and ``fitting.refit``, which leaves the restart draws
(``fitting.starts``) and the call's own host work, summed over the window
and averaged over its fits.  ``fit.optimize_ms_per_fit`` counts the draws
too (its first stage holds them), so this, it and ``fit.refit_ms_per_fit``
add up to the root spans and the draws once more.  A program without the
recorder (``mogp_tpu_torch.utils.metrics``) gives nothing to read."""

PHASES = ("fitting.stage", "fitting.rescue", "fitting.refit")


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "spans"):
        return None
    spans = metrics.spans()
    roots = {s.id: s.seconds for s in spans if s.name == "fitting.fit_GP_MAP"}
    if not roots:
        return None
    phases = sum(s.seconds for s in spans
                 if s.name in PHASES and s.parent in roots)
    return 1e3 * (sum(roots.values()) - phases) / len(run.records)
