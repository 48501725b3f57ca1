"""Milliseconds a wave spends on its query points on the host: the
program's span ``hm.inputs`` (``_process_inputs`` of the pool, and each
group's query tensor made and copied to the card), summed over the window
and averaged over its waves.  A program without the recorder
(``mogp_tpu_torch.utils.metrics``) gives nothing to read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "spans"):
        return None
    seconds = [s.seconds for s in metrics.spans() if s.name == "hm.inputs"]
    return 1e3 * sum(seconds) / len(run.records) if seconds else None
