"""The ``sweep`` traffic: a closed loop of history-matching waves.

Set-up fits the configuration's emulators at seeded hyperparameters
(``MultiOutputGP.fit``, no MAP fit) and draws one pool of candidate inputs,
uniform in the unit cube, with numpy.  Each request is one wave:
``HistoryMatching(gp, obs, coords=pool).get_implausibility(rank)`` with the
wave's own observations (the simulator at a seeded point, variances
uniform in ``obs_var``), its implausibilities returned to the host.  Wave 0
is the warm-up.

The hyperparameters and the observations' simulator are the
configuration's reference's (``seeded_raw``) and data generator's
(``simulator``), ``cells.py``.

After the window, on a sample of each wave's points drawn from the seed,
the implausibilities are judged against that plain reference in float64
(the prediction's mean and variance, the implausibility, the rank
selection):

* ``wrong_count``: waves that returned another number of points than the
  pool holds, or a value that is not finite (limit 0);
* ``nugget_off_ladder``: emulators whose nugget is none that the
  reference's model allows (the default reference's adaptive nugget: no
  rung of its own ladder) (limit 0);
* ``I_gap``: the largest gap between the program's implausibility and the
  reference's, relative to the reference's where that is above 1 and
  absolute below (a rank's implausibility near 0 has no relative digits
  to compare).
"""

import time

import numpy as np

from . import cells, data, window
from .fitloop import build
from .trace import Tracer


def observations(cell, seeds, k):
    """Wave ``k``'s observations ``[means, variances]`` over the outputs."""
    d = cell.config["data"]
    lo, hi = cell.traffic["obs_var"]
    rs = np.random.RandomState(seeds.request(k))
    x_star = rs.uniform(size=(1, d["n_dim"]))
    mean = data.simulator(cell.config, x_star, seeds.data)[:, 0]
    return [mean, rs.uniform(lo, hi, size=d["n_outputs"])]


def thetas(config, seeds):
    """The emulators' raw hyperparameters, seeded."""
    d = config["data"]
    return cells.reference(config).seeded_raw(d["n_outputs"], d["n_dim"], seeds.data)


def run(cell, seeds, seconds, trace, device):
    """Set up, warm up, run the window (see the module doc)."""
    import torch

    import mogp_tpu_torch as mt

    t = cell.traffic
    x, y = data.problem(cell.config, seeds.data)
    raw = thetas(cell.config, seeds)
    model = build(cell.config, x, y, device)
    model.fit(raw)
    nuggets = np.array([em.nugget for em in model.emulators])
    pool = np.random.default_rng([seeds.data, 1]).random((t["pool_points"], x.shape[1]))
    sample = t["check_points_per_wave"]

    def wave(k):
        obs = observations(cell, seeds, k)
        t0 = time.perf_counter()
        I = mt.HistoryMatching(gp=model, obs=obs, coords=pool).get_implausibility(
            rank=t["rank"])
        seconds = time.perf_counter() - t0
        idx = seeds.check.integers(0, len(pool), size=sample)
        ok = len(I) == len(pool) and bool(np.isfinite(I).all())
        return {"seconds": seconds, "points": len(I), "failed": not ok, "obs": obs,
                "idx": idx, "I": np.asarray(I)[idx] if len(I) == len(pool) else None}

    wave(0)
    records = []
    tracer = Tracer(trace)
    opened = time.time()
    with tracer.window():
        n, elapsed = window.closed_loop(lambda k: records.append(wave(k + 1)), seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"x": x, "y": y, "raw": raw, "nuggets": nuggets, "pool": pool,
            "records": records, "window_s": elapsed, "opened": opened, "peak": peak,
            "trace": tracer.summary,
            "rates": {"query_points_per_s": sum(r["points"] for r in records) / elapsed},
            "attempted": n, "failed": sum(r["failed"] for r in records)}


def control_outputs(config, out, rank, device):
    """The control in the program's place: the emulators' nuggets and the
    implausibilities of the sampled points as the reference gives them in
    TF32 (float32 with TF32 products), at its own nugget."""
    R = cells.reference(config)
    out["nuggets"], _ = R.own_fit(out["raw"], out["x"], out["y"], R.priors(out["x"]), device,
                                  tf32=True)
    for r in out["records"]:
        r["I"] = R.implausibility(out["raw"], out["nuggets"], out["x"], out["y"],
                                  out["pool"][r["idx"]], *r["obs"], rank, device, tf32=True)


def check(config, out, rank, device):
    """The numbers compared for a run's waves (see the module doc)."""
    R = cells.reference(config)
    allowed, _ = R.judge(out["raw"], out["nuggets"], out["x"], out["y"], R.priors(out["x"]),
                         device)
    off = int((~allowed).sum())
    worst = 0.0
    if not off:
        for r in out["records"]:
            if r["I"] is None:
                continue
            ref = R.implausibility(out["raw"], out["nuggets"], out["x"], out["y"],
                                   out["pool"][r["idx"]], *r["obs"], rank, device)
            rel = np.abs(r["I"] - ref) / np.maximum(np.abs(ref), 1.0)
            worst = max(worst, float(np.nan_to_num(rel.max(), nan=np.inf)))
    return {"wrong_count": sum(r["failed"] for r in out["records"]),
            "nugget_off_ladder": off, "I_gap": worst if not off else float("inf")}
