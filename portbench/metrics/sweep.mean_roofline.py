"""The sweep's prediction work as a share of its roofline, where the
emulators carry a mean and the Matern 5/2 kernel: the least time the card
could take for the window's waves (their operations, the mean terms and
the Matern base counted, over the float32-accurate peak, or their bytes
over the memory rate, the larger), over the union of every compute kernel
in the traced window, whatever kernel does the work.  The work is counted
from the cell's shapes (``pbcore/work_mean.py``), never from a launch; the
fused prediction kernel takes nearly all of it."""

from pbcore import work, work_mean


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0.0:
        return None
    d = run.cell.config["data"]
    points = sum(r["points"] for r in run.records)
    flops = points * work_mean.predict_flops_mean(d["n_points"], d["n_dim"],
                                                  work_mean.mean_terms(run.cell.config), d["n_outputs"])
    n_bytes = points * work.predict_bytes(d["n_dim"], run.cell.traffic["rank"] + 1)
    return 100.0 * work.least_seconds(flops, n_bytes) / run.trace["kernel_s"]
