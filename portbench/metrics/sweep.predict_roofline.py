"""The sweep's prediction work as a share of its roofline: the least time
the card could take for the window's waves (their operations over the
float32-accurate peak, or their bytes over the memory rate, the larger),
over the union of every compute kernel in the traced window, whatever
kernel does the work.  The work is counted from the cell's shapes
(``pbcore/work.py``), never from a launch."""

from pbcore import work


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0.0:
        return None
    d = run.cell.config["data"]
    points = sum(r["points"] for r in run.records)
    flops = points * work.predict_flops(d["n_points"], d["n_dim"], d["n_outputs"])
    n_bytes = points * work.predict_bytes(d["n_dim"], run.cell.traffic["rank"] + 1)
    return 100.0 * work.least_seconds(flops, n_bytes) / run.trace["kernel_s"]
