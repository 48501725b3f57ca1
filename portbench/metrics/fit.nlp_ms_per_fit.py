"""Milliseconds a fit spends enqueuing its objective: the program's spans
``gp.nlp`` (``gp_nlp``'s forward) and ``lbfgs.grad`` (its backward, in
``ops/lbfgs.py``) that lie under a ``fitting.stage`` or ``fitting.rescue``,
summed over the window and averaged over its fits.  A host clock: the
launch-bound fit's enqueue, not the device's time.  The recorder
(``mogp_tpu_torch.utils.metrics``) is on while the profiler records, so it
holds the window's fits alone; a program without it gives nothing to
read."""

OBJECTIVE = ("gp.nlp", "lbfgs.grad")
OPTIMIZE = ("fitting.stage", "fitting.rescue")


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "spans"):
        return None
    spans = metrics.spans()
    by_id = {s.id: s for s in spans}

    def optimizing(s):
        while s.parent in by_id:
            s = by_id[s.parent]
            if s.name in OPTIMIZE:
                return True
        return False

    seconds = [s.seconds for s in spans if s.name in OBJECTIVE and optimizing(s)]
    return 1e3 * sum(seconds) / len(run.records) if seconds else None
