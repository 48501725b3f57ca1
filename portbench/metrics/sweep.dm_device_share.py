"""The share of a sweep's query rows whose mean design matrix was built on
the card: the program's counter ``predict.dm_rows_device`` over it plus
``predict.dm_rows_host`` (``models/mogp.py``: the rows of each prediction
group with mean terms, by where its design matrix was made), over the
window.  1 where every formula mean's columns are built on the card tile
by tile, 0 where they are built on the host and copied.  A program without
those counters, or a sweep with no mean terms, gives nothing to read."""


def read(run):
    from mogp_tpu_torch.utils import metrics

    if not run.records or not hasattr(metrics, "counters"):
        return None
    counters = metrics.counters()
    device = counters.get("predict.dm_rows_device", 0)
    rows = device + counters.get("predict.dm_rows_host", 0)
    return device / rows if rows else None
