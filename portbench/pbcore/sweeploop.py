"""The ``sweep`` traffic: a closed loop of history-matching waves.

Set-up fits the configuration's emulators at seeded hyperparameters
(``MultiOutputGP.fit``, no MAP fit) and draws one pool of candidate inputs,
uniform in the unit cube, with numpy.  Each request is one wave:
``HistoryMatching(gp, obs, coords=pool).get_implausibility(rank)`` with the
wave's own observations (the simulator at a seeded point, variances
uniform in ``obs_var``), its implausibilities returned to the host.  Wave 0
is the warm-up.

After the window, on a sample of each wave's points drawn from the seed,
the implausibilities are judged against the plain reference in float64
(the prediction's mean and variance, the implausibility, the rank
selection):

* ``wrong_count``: waves that returned another number of points than the
  pool holds, or a value that is not finite (limit 0);
* ``nugget_off_ladder``: emulators whose nugget is no rung of the
  reference's own ladder (limit 0);
* ``I_gap``: the largest gap between the program's implausibility and the
  reference's, relative to the reference's where that is above 1 and
  absolute below (a rank's implausibility near 0 has no relative digits
  to compare).
"""

import time

import numpy as np

from . import data, window
from .fitloop import build
from .trace import Tracer


def observations(cell, seeds, k):
    """Wave ``k``'s observations ``[means, variances]`` over the outputs."""
    d = cell.config["data"]
    lo, hi = cell.traffic["obs_var"]
    rs = np.random.RandomState(seeds.request(k))
    x_star = rs.uniform(size=(1, d["n_dim"]))
    mean = data.tsunami_simulator(x_star, d["n_points"], d["n_outputs"], seeds.data)[:, 0]
    return [mean, rs.uniform(lo, hi, size=d["n_outputs"])]


def thetas(config, seeds):
    """The emulators' raw hyperparameters, seeded."""
    d = config["data"]
    return data.tsunami_thetas(d["n_outputs"], d["n_dim"], seeds.data)


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


def _inputs(out, device, dtype):
    import torch

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return t(out["raw"]), t(out["x"]), t(out["y"])


def control_outputs(out, rank, device):
    """The control in the program's place: the implausibilities of the
    sampled points as the reference gives them in TF32 (float32 with TF32
    products), at its own adaptive nugget."""
    import torch

    from reference import gp_ref as R

    raw, X, Y = _inputs(out, device, torch.float32)
    rungs, _ = R.adaptive(raw, X, Y, R.default_corr_priors(out["x"]), mm=R.tf32_mm)
    md = R.mean_diag(raw.double(), X.double()).cpu().numpy()
    out["nuggets"] = np.array([R.LADDER[k] * m if k >= 0 else np.nan
                               for k, m in zip(rungs, md)])
    for r in out["records"]:
        q = torch.as_tensor(out["pool"][r["idx"]], dtype=torch.float32, device=device)
        mu, var = R.predict(raw, X, Y, rungs, q, mm=R.tf32_mm)
        o = [torch.as_tensor(v, dtype=torch.float32, device=device) for v in r["obs"]]
        r["I"] = R.implausibility(mu, var, o[0], o[1], rank).double().cpu().numpy()


def check(out, rank, device):
    """The numbers compared for a run's waves (see the module doc)."""
    import torch

    from reference import gp_ref as R

    raw, X, Y = _inputs(out, device, torch.float64)
    md = R.mean_diag(raw, X).cpu().numpy()
    rungs = [R.rung_of(g, m) for g, m in zip(out["nuggets"], md)]
    off = sum(r < 0 for r in rungs)
    worst = 0.0
    if not off:
        for r in out["records"]:
            if r["I"] is None:
                continue
            q = torch.as_tensor(out["pool"][r["idx"]], dtype=torch.float64, device=device)
            mu, var = R.predict(raw, X, Y, rungs, q)
            o = [torch.as_tensor(v, dtype=torch.float64, device=device) for v in r["obs"]]
            ref = R.implausibility(mu, var, o[0], o[1], rank).cpu().numpy()
            rel = np.abs(r["I"] - ref) / np.maximum(np.abs(ref), 1.0)
            worst = max(worst, float(np.nan_to_num(rel.max(), nan=np.inf)))
    return {"wrong_count": sum(r["failed"] for r in out["records"]),
            "nugget_off_ladder": int(off), "I_gap": worst if not off else float("inf")}
