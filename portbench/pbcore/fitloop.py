"""The ``fit`` traffic: a closed loop of whole MAP fits of a configuration.

Each request is one ``fit_GP_MAP`` of every emulator of the configuration,
with every restart, the race, any rescue and the refit of the winners,
from the next restart seed of the run's sequence (``Seeds.request``), so
the parent and a change do the same work on the same seed.  One warm-up
fit at the cell's own shapes (restart seed 0) is set-up.

After the window the fits are judged against the plain reference that
the configuration names (``cells.py``), on every emulator of every fit:

* ``unfit``: emulators left without a finite fit (limit 0);
* ``nugget_off_ladder``: fitted emulators whose nugget is none that the
  reference's model allows at their hyperparameters (the default
  reference's adaptive nugget: no rung of its own ladder) (limit 0);
* ``nlp_gap``: the largest gap, in nats, between the program's negative log
  posterior and the reference's in float64 at the program's
  hyperparameters and nugget: the kernel matrix, the jitter ladder, the
  Cholesky factor, the solves, the priors and the refit;
* ``unmoved``: fitted emulators whose hyperparameters are one of their own
  restart points, which the reference draws again from the priors and the
  fit's seed, as mogp-emulator draws them: the optimizer left them where
  they started (limit 0);
* ``polish_gain``, where the cell's limits name it: on a sample drawn from
  the seed, the most that the reference's own L-BFGS-B, started at the
  program's winner, lowers the negative log posterior: whether the
  optimizer, the race and the restarts reached a minimum;
* ``winner_above_start``, where the cell's limits name it: the median, over
  the run's fitted emulators, of the reference's negative log posterior at
  the program's winner less the least at the emulator's redrawn restart
  points (each at the reference's own nugget there, in float64), in nats.  It
  is below 0 where the optimizer descended; a step that never moves, or one
  steered by a wrong gradient, leaves it at 0.  The median, as a random
  best start lies anywhere from a few nats to thousands above the minimum:
  the emulator that descends least tells little;
* ``starts_off``, where the cell's limits name it: after the window,
  ``fit_GP_MAP`` runs once more with no iteration from the first timed
  fit's restart seed; its emulators that end on none of the restart points
  the reference redraws (limit 0).  ``unmoved`` and ``winner_above_start``
  rest on the program drawing its restarts as mogp-emulator does: this
  fails the run as soon as it no longer does.
"""

import time

import numpy as np

from . import cells, data, window
from .trace import Tracer

# emulators of a run that the reference polishes, where a cell compares
# ``polish_gain``: each polish is ~30 objective evaluations in float64
POLISH = 6


# the keys of a configuration's ``model``
MODEL = ("class", "kernel", "mean", "nugget", "priors", "dtype")


def build(config, x, y, device):
    """The configuration's model on ``device``, before any fit: the class
    (``MultiOutputGP`` or ``GaussianProcess``) with every argument that the
    ``model`` entry states.

    * ``kernel``: the kernel's name;
    * ``mean``: a formula such as ``"x[0]+x[1]"``; ``"zero"`` or none: no
      mean function;
    * ``nugget``: ``"adaptive"``, ``"fit"``, ``"pivot"`` or a number;
    * ``priors``: ``GPPriors``' arguments, each distribution a list of its
      class and arguments (``["LogNormalPrior", 1.0, 1.0]``, ``null`` for
      none): ``{"mean": {"mean": [...], "cov": [...]}, "corr": [one an
      input], "cov": ..., "nugget": ..., "nugget_type": "fit"}``; none: the
      port's default priors;
    * ``dtype``: the torch dtype's name.

    A key it does not know is an error."""
    import torch

    import mogp_tpu_torch as mt

    m = config["model"]
    unknown = sorted(set(m) - set(MODEL))
    if unknown:
        raise ValueError("unknown model keys {}".format(", ".join(unknown)))
    if m["class"] not in ("MultiOutputGP", "GaussianProcess"):
        raise ValueError("unknown model class {!r}".format(m["class"]))
    kw = {k: m[k] for k in ("kernel", "nugget") if k in m}
    if isinstance(kw.get("nugget"), (int, float)):
        kw["nugget"] = float(kw["nugget"])
    if m.get("mean", "zero") != "zero":
        kw["mean"] = m["mean"]
    if "priors" in m:
        kw["priors"] = _priors(m["priors"])
    kw.update(device=device, dtype=getattr(torch, m["dtype"]))
    if m["class"] == "MultiOutputGP":
        return mt.MultiOutputGP(x, y, **kw)
    return mt.GaussianProcess(x, y[0], **kw)


def _priors(spec):
    """``GPPriors`` from its JSON spelling (see :func:`build`), built through
    ``mogp_tpu_torch.Priors``."""
    from mogp_tpu_torch import Priors

    def dist(d):
        if d is None:
            return None
        cls = getattr(Priors, d[0], None)
        if not (isinstance(cls, type) and issubclass(cls, Priors.WeakPrior)):
            raise ValueError("unknown prior distribution {!r}".format(d[0]))
        return cls(*d[1:])

    kw = dict(spec)
    if kw.get("mean") is not None:
        kw["mean"] = Priors.MeanPriors(**kw["mean"])
    if kw.get("corr") is not None:
        kw["corr"] = [dist(d) for d in kw["corr"]]
    for key in ("cov", "nugget"):
        if key in kw:
            kw[key] = dist(kw[key])
    return Priors.GPPriors(**kw)


def emulators(model):
    return getattr(model, "emulators", [model])


def _reset_counters():
    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.ops import cholesky_batched, cholesky_blocked

    cholesky_batched.launches = 0
    for v in cholesky_blocked.launches:
        cholesky_blocked.launches[v] = 0
    del fitting.last_phase_times[:]


def _launches():
    from mogp_tpu_torch.ops import cholesky_batched, cholesky_blocked

    return cholesky_batched.launches + sum(cholesky_blocked.launches.values())


def fit_once(model, fit, seed, device, mesh=None):
    """One request: the fit from restart seed ``seed``, its results on the
    host, and the program's counters of it."""
    import torch

    import mogp_tpu_torch as mt
    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.parallel import mesh as pmesh

    np.random.seed(seed)
    _reset_counters()
    t0 = time.perf_counter()
    raised = False
    try:
        mt.fit_GP_MAP(model, n_tries=fit["n_tries"], maxiter=fit["maxiter"],
                      refit=fit["refit"], mesh=mesh)
    except RuntimeError:  # a single GP that no restart could fit
        raised = True
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    ems = emulators(model)
    theta = np.full((len(ems), ems[0].n_params), np.nan)
    nlp = np.full(len(ems), np.nan)
    nugget = np.full(len(ems), np.nan)
    for i, em in enumerate(ems):
        raw = em.theta.get_data()
        if raw is not None:
            theta[i], nlp[i], nugget[i] = raw, em.current_logpost, em.nugget
    return {"seconds": seconds, "seed": seed, "theta": theta, "nlp": nlp, "nugget": nugget,
            "failed": raised or not np.isfinite(nlp).all(), "launches": _launches(),
            "phases": list(fitting.last_phase_times),
            "gathers": list(pmesh.last_gathers) if mesh is not None else []}


def run(cell, seeds, seconds, trace, device, mesh=None, agree=None, barrier=None):
    """Set up, warm up, run the window.  Returns the run's record: each
    fit's results, the window, the peak memory and the trace.

    With ``"problems": P`` in the traffic, set-up builds P models, each on
    data of its own (the first from ``Seeds.data``, the others from the
    next request seeds), and fit ``k`` refits model ``k mod P``: a run then
    averages the work over P problems instead of resting on one."""
    import torch

    fit = cell.config["fit"]
    n_problems = cell.traffic.get("problems", 1)
    data_seeds = [seeds.data] + [seeds.request(10**6 + p) for p in range(1, n_problems)]
    models = [build(cell.config, *data.problem(cell.config, s), device) for s in data_seeds]

    def request(k):
        p = k % n_problems
        return dict(fit_once(models[p], fit, seeds.request(k), device, mesh),
                    data=data_seeds[p], problem=p)

    request(0)
    if barrier is not None:
        barrier()
    records = []
    tracer = Tracer(trace)
    opened = time.time()
    with tracer.window():
        n, elapsed = window.closed_loop(lambda k: records.append(request(k + 1)), seconds,
                                        agree)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    probe = None
    if "starts_off" in cell.limits and records:
        first = records[0]
        probe = {"seed": first["seed"], "data": first["data"],
                 "theta": _probe_starts(models[first["problem"]], fit, first["seed"])}
    del models
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"records": records, "window_s": elapsed, "opened": opened, "peak": peak,
            "trace": tracer.summary,
            "rates": {"fits_per_s": sum(len(r["nlp"]) for r in records) / elapsed},
            "attempted": n, "failed": sum(r["failed"] for r in records), "probe": probe}


def _probe_starts(model, fit, seed):
    """The hyperparameters ``(E, P)`` at which ``fit_GP_MAP`` ends with no
    iteration from restart seed ``seed``: the best of the restart points
    that it draws (NaN where an emulator has none)."""
    import mogp_tpu_torch as mt

    np.random.seed(seed)
    try:
        mt.fit_GP_MAP(model, n_tries=fit["n_tries"], maxiter=0, race=False,
                      refit=fit["refit"])
    except RuntimeError:
        pass
    ems = emulators(model)
    theta = np.full((len(ems), ems[0].n_params), np.nan)
    for i, em in enumerate(ems):
        raw = em.theta.get_data()
        if raw is not None:
            theta[i] = raw
    return theta


def _blocks(n_lanes, n):
    """Lanes per block of the reference, about 2 GB of float64 work each."""
    return max(1, min(n_lanes, int(2e9 // (48 * n * n))))


def control_outputs(config, records, device):
    """The control in the program's place: each emulator's nugget and
    negative log posterior as the reference gives them in TF32 (float32
    with TF32 products), at the hyperparameters of each fit."""
    R = cells.reference(config)
    for r in records:
        x, y = data.problem(config, r["data"])
        idx = np.flatnonzero(np.isfinite(r["theta"]).all(1))
        r["nugget"][idx], r["nlp"][idx] = R.own_fit(r["theta"][idx], x, y[idx], R.priors(x),
                                                    device, tf32=True)


def _judge(R, x, y, r, priors, device):
    """One fit's emulators against the reference ``R``: whether their nugget
    is one its model allows, and its negative log posterior at their
    hyperparameters and nugget (NaN where not judged)."""
    allowed = np.zeros(len(r["nlp"]), dtype=bool)
    ref = np.full(len(r["nlp"]), np.nan)
    idx = np.flatnonzero(np.isfinite(r["theta"]).all(1) & np.isfinite(r["nlp"]))
    step = _blocks(len(idx), x.shape[0])
    for b in range(0, len(idx), step):
        lanes = idx[b:b + step]
        allowed[lanes], ref[lanes] = R.judge(r["theta"][lanes], r["nugget"][lanes], x, y[lanes],
                                             priors, device)
    return allowed, ref


def _best_start(R, x, y, starts, lanes, priors, device):
    """The reference's least negative log posterior ``(E,)`` over the
    restart points ``(E, T, P)`` of the emulators ``lanes``, each point at
    its own nugget there in float64 (NaN where no point of an emulator has
    one, or the emulator is not in ``lanes``)."""
    pairs = [(e, t) for e in np.flatnonzero(lanes) for t in range(starts.shape[1])]
    best = np.full(starts.shape[0], np.inf)
    step = _blocks(len(pairs), x.shape[0])
    for b in range(0, len(pairs), step):
        chunk = pairs[b:b + step]
        _, v = R.own_fit(np.stack([starts[e, t] for e, t in chunk]), x,
                         np.stack([y[e] for e, _ in chunk]), priors, device)
        for (e, _), value in zip(chunk, v):
            if np.isfinite(value):
                best[e] = min(best[e], value)
    return np.where(np.isfinite(best), best, np.nan)


def _unmoved(theta, starts):
    """Rows of ``theta`` ``(E, P)`` that equal one of their own restart
    points ``(E, T, P)`` to float32 rounding."""
    near = np.abs(theta[:, None, :] - starts) <= 1e-6 * (1.0 + np.abs(starts))
    return near.all(-1).any(-1)


def check(config, records, seeds, polish, device, descent=False, probe=None):
    """The numbers compared for ``records`` (see the module doc);
    ``polish`` emulators are polished, none where it is 0;
    ``winner_above_start`` where ``descent``; ``starts_off`` where a
    ``probe`` (``run``'s) is given."""
    R = cells.reference(config)
    problems = {s: data.problem(config, s) for s in {r["data"] for r in records}}
    priors = {s: R.priors(x) for s, (x, _) in problems.items()}
    unfit = off = unmoved = 0
    gap = 0.0
    above = []     # winner less best start, each judged emulator
    judged = []    # (record, emulator) pairs the reference judged
    for i, r in enumerate(records):
        allowed, ref = _judge(R, *problems[r["data"]], r, priors[r["data"]], device)
        fitted = np.isfinite(r["theta"]).all(1) & np.isfinite(r["nlp"])
        unfit += int((~fitted).sum())
        off += int((fitted & ~allowed).sum())
        starts = R.restart_points(priors[r["data"]], len(r["nlp"]), config["fit"]["n_tries"],
                                  r["seed"])
        unmoved += int((fitted & _unmoved(r["theta"], starts)).sum())
        on = fitted & allowed
        if on.any():
            gap = max(gap, float(np.nan_to_num(np.abs(r["nlp"][on] - ref[on]).max(),
                                               nan=np.inf)))
        if descent and on.any():
            best = _best_start(R, *problems[r["data"]], starts, on, priors[r["data"]], device)
            above += [v for v in ref[on] - best[on] if np.isfinite(v)]
        judged += [(i, e) for e in np.flatnonzero(on)]
    out = {"unfit": unfit, "nugget_off_ladder": off, "nlp_gap": gap, "unmoved": unmoved}
    if descent:
        out["winner_above_start"] = float(np.median(above)) if above else np.nan
    if probe is not None:
        starts = R.restart_points(priors[probe["data"]], len(probe["theta"]),
                                  config["fit"]["n_tries"], probe["seed"])
        on_start = np.isfinite(probe["theta"]).all(1) & _unmoved(probe["theta"], starts)
        out["starts_off"] = int((~on_start).sum())
    if polish:
        gain = 0.0
        for j in seeds.check.choice(len(judged), size=min(polish, len(judged)),
                                    replace=False):
            i, e = judged[j]
            x, y = problems[records[i]["data"]]
            start, best = R.polish(records[i]["theta"][e], records[i]["nugget"][e], x, y[e],
                                   priors[records[i]["data"]], device)
            gain = max(gain, start - best)
        out["polish_gain"] = gain
    return out


def disagreements(procs):
    """Emulator results (per fit) that a process holds otherwise than
    process 0, bit for bit, or does not hold; and fits that a process ran
    otherwise than process 0."""
    base = procs[0]
    count = 0
    for other in procs[1:]:
        count += abs(len(other) - len(base)) * len(base[0]["nlp"])
        for a, b in zip(base, other):
            differ = np.zeros(len(a["nlp"]), dtype=bool)
            for key in ("theta", "nlp", "nugget"):
                u, v = np.asarray(a[key]), np.asarray(b[key])
                same = (u == v) | (np.isnan(u) & np.isnan(v))
                differ |= ~same.reshape(len(differ), -1).all(1)
            count += int(differ.sum())
    return count
