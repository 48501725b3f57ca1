"""The whole sweep's share of the card's peak, where the emulators carry a
mean and the Matern 5/2 kernel: the window's prediction operations (the
same count as ``sweep.mean_roofline``) over the traced window times the
float32-accurate peak.  It still bounds a gain after a change takes the
fused kernel off the path."""

from pbcore import work, work_mean


def read(run):
    if run.trace is None:
        return None
    d = run.cell.config["data"]
    points = sum(r["points"] for r in run.records)
    flops = points * work_mean.predict_flops_mean(d["n_points"], d["n_dim"],
                                                  work_mean.mean_terms(run.cell.config),
                                                  d["n_outputs"])
    return 100.0 * flops / (run.trace["window_s"] * work.PEAKS["flops_per_s"]["float32"])
