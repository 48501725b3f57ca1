"""Milliseconds a fit spends in the gathers across processes
(``parallel.mesh.last_gathers``: pickling, gloo, unpickling, and the wait
for the slower processes), summed per fit and averaged over the window's
fits, in the process that spent the most."""


def read(run):
    per_proc = [sum(s for r in recs for s, _ in r["gathers"]) / len(recs)
                for recs in run.procs if recs and any(r["gathers"] for r in recs)]
    return 1e3 * max(per_proc) if per_proc else None
