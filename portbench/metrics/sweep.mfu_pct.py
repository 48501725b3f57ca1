"""The whole sweep's share of the card's peak: the window's prediction
operations (the same count as ``sweep.predict_roofline``) over the traced
window times the float32-accurate peak.  It still bounds a gain after a
change takes the fused kernel off the path."""

from pbcore import work


def read(run):
    if run.trace is None:
        return None
    d = run.cell.config["data"]
    points = sum(r["points"] for r in run.records)
    flops = points * work.predict_flops(d["n_points"], d["n_dim"], d["n_outputs"])
    return 100.0 * flops / (run.trace["window_s"] * work.PEAKS["flops_per_s"]["float32"])
