"""Milliseconds a fit spends refitting its winners on the full jitter
ladder (``gp_fit``, and across processes the gather of the winners): the
``refit`` entry of ``models.fitting.last_phase_times``, averaged over the
window's fits (process 0's)."""


def read(run):
    fits = [sum(s for label, s in r["phases"] if label == "refit")
            for r in run.records if r["phases"]]
    return 1e3 * sum(fits) / len(fits) if fits else None
