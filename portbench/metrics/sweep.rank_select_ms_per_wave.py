"""Milliseconds a wave spends in the rank selection on the host: the
program's span ``hm.rank_select`` (the ``np.partition`` over the groups'
top-k), summed over the window and averaged over its waves.  A program
without the recorder (``mogp_tpu_torch.utils.metrics``) gives nothing to
read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "spans"):
        return None
    seconds = [s.seconds for s in metrics.spans() if s.name == "hm.rank_select"]
    return 1e3 * sum(seconds) / len(run.records) if seconds else None
