"""Milliseconds a fit spends optimizing: the ``stage*`` and ``rescue``
entries of the program's ``models.fitting.last_phase_times``, summed per
fit and averaged over the window's fits (process 0's).  A host clock; the
lockstep L-BFGS syncs every iteration, so it holds the device's time too.
Only the multi-output path records phases: nothing to read elsewhere."""


def read(run):
    fits = [sum(s for label, s in r["phases"] if label.startswith("stage") or label == "rescue")
            for r in run.records if r["phases"]]
    return 1e3 * sum(fits) / len(fits) if fits else None
