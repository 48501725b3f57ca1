"""MAP hyperparameter estimation with the batched L-BFGS of ``ops/lbfgs.py``.

Port of ``mogp_tpu/models/fitting.py``.  Every (output, restart) pair is a
lane of one batched minimization of ``gp_nlp``; the outputs of a
``MultiOutputGP`` that share a configuration signature go through it
together.  The schedule is the JAX package's:

* starts: ``theta0`` first when given, then prior samples from the host
  numpy RNG (``GPPriors.sample_n``), so a seeded fit starts where
  ``mogp_tpu`` does;
* the race: a short first stage on all restarts, then only the best
  quarter of each output's restarts runs on (``_race_plan``);
* the optimizer's trajectory factors with the one-rung ("single") jitter
  ladder under ``nugget="adaptive"``; an output whose every restart came
  out non-finite is run again with the full ladder before it is declared
  unfit;
* the winner of each output is refit with the full ladder by the batched
  ``gp_fit`` (``MultiOutputGP._fit_lanes``).

With ``mesh=`` (a ``parallel.DeviceMesh``) every stage, the rescue and the
refit split each chunk's outputs over the mesh, whole outputs per shard
(an output's restarts stay together); the starts are drawn on the host
before the split, and a lane does not depend on the others, so the
per-output results do not depend on the mesh.  A mesh that spans
processes (``parallel.init_distributed``) splits the same way: each
process minimizes and refits its own shards' outputs, and after each
chunk of each stage, and after the refit, every process receives every
shard's results (``parallel.mesh.map_shards``), so everything after
(the race's choice, the rescue, the winners) runs alike in every
process, and each ends up holding the whole fit.  Every process draws
the same starts only if every process seeds numpy's RNG alike.

Failure semantics match the reference: restarts with a non-finite
objective are dropped; an output with no finite restart is left unfit
(``theta`` is ``None``, ``get_indices_not_fit`` lists it), and a single
GP raises.
"""

import time
import warnings

import numpy as np
import torch

from ..ops.lbfgs import lbfgs_minimize
from ..parallel import mesh as pmesh
from ..parallel.mesh import check_mesh, map_shards, split_rows, to_device
from .gp import GaussianProcess, GaussianProcessBase, cat_lanes, gp_nlp, take_lanes
from .mogp import MultiOutputGP

__all__ = ["fit_GP_MAP"]

_GP_KWARGS = ["mean", "kernel", "priors", "nugget", "inputdict", "use_patsy", "device", "dtype"]

# jitter ladder of the optimizer's trajectory under nugget="adaptive"
# (ops/cholesky.py): "single" = 1 candidate per objective evaluation,
# "sparse" = 3, "full" = the reference's 6; the refit always uses "full"
_LADDER_MODES = {"sparse": True, "single": "single", "full": False}
_DEFAULT_LADDER = "single"

# Lanes per batched minimization are bounded by device memory only: a lane
# never depends on the others, so chunking changes no result.  Peak device
# memory per lane, in (n, n) matrices, measured at the headline's n = 210
# in float32 on an H100 (tools/prof_fit.py): 8.2 for a value + gradient on
# the one-rung ladder, 19.7 for a minimization on the full 6-rung ladder
# (the rescue path), 17.6 for the refit.  _LANE_MATRICES = 24 covers the
# largest with a margin.  _CHUNK_BYTES of them at a time leaves the card's
# 80 GB ample room: ~4000 lanes at n = 210 in float32, so the 64 x 15 lanes
# of the headline fit run in one chunk.
_CHUNK_BYTES = 16 * 2**30
_LANE_MATRICES = 24

# (label, seconds) per phase of the last _fit_MOGP_MAP call; every phase
# ends with its results on the host, so the splits are device time too
last_phase_times = []


def _max_lanes(em):
    item = torch.finfo(em._dtype).bits // 8
    return max(1, _CHUNK_BYTES // (_LANE_MATRICES * em.n * em.n * item))


def _minimize(starts, data, kernel, nugget_type, maxiter, gtol, ftol, ladder):
    """One batched L-BFGS over lanes: ``starts`` ``(L, P)``, ``data`` a
    ``GPData`` of ``L`` lanes."""
    return lbfgs_minimize(
        lambda raw: gp_nlp(raw, data, kernel, nugget_type, sparse_ladder=ladder,
                           progressive_ok=False),
        starts, maxiter=maxiter, gtol=gtol, ftol=ftol,
    )


def _host(t):
    return t.to("cpu", torch.float64).numpy()


def _gather_starts(gp, n_tries, theta0):
    """Starting points ``(n_tries, P)``: ``theta0`` first (if given), prior
    samples after, from the host numpy RNG (slot-major, as ``mogp_tpu``)."""
    n_sampled = n_tries
    head = []
    if theta0 is not None:
        theta = np.array(theta0, dtype=np.float64)
        assert theta.shape == (gp.n_params,), (
            "theta0 must be a 1D array with length n_params"
        )
        head = [theta[None, :]]
        n_sampled -= 1
    sampled = np.asarray(gp.priors.sample_n(n_sampled), dtype=np.float64)
    return np.concatenate(head + [sampled], axis=0) if head else sampled


def _extract_opt_options(kwargs):
    maxiter = int(kwargs.pop("maxiter", 200))
    gtol = kwargs.pop("gtol", None)
    ftol = kwargs.pop("ftol", None)
    gtol = None if gtol is None else float(gtol)
    ftol = None if ftol is None else float(ftol)
    race = bool(kwargs.pop("race", True))
    ladder = _LADDER_MODES[kwargs.pop("opt_ladder", None) or _DEFAULT_LADDER]
    kwargs.pop("processes", None)  # accepted for API parity; lanes replace it
    if kwargs:
        warnings.warn(
            "ignoring unsupported optimizer options: {}".format(sorted(kwargs))
        )
    return maxiter, gtol, ftol, race, ladder


def _race_plan(n_tries, maxiter, race):
    """Restart tournament ("race") schedule of ``mogp_tpu``.

    Every restart runs a first stage of ``max(12, 9 maxiter / 20)``
    iterations; the best ``ceil(n_tries / 4)`` (at least 2) of each output
    then run the rest of the budget (at least 12).  The winner meets the
    same convergence tests on the same objective; ``race=False`` gives
    the reference's all-restarts-full-budget schedule.

    :returns: ``[(iters, keep), (iters, None)]``, or ``None`` when racing
        is off or not worthwhile.
    """
    if not race or n_tries < 4 or maxiter < 16:
        return None
    phase_a = max(12, (9 * maxiter) // 20)
    keep = max(2, -(-n_tries // 4))
    return [(phase_a, keep), (max(maxiter - phase_a, 12), None)]


def _check_method(method):
    if method not in ("L-BFGS-B", "L-BFGS", "lbfgs"):
        warnings.warn(
            "method '{}' is not available on device; using batched L-BFGS".format(method)
        )


def _best(fun_row):
    """Index of the smallest finite value, or ``None``."""
    finite = np.isfinite(fun_row)
    if not finite.any():
        return None
    return int(np.nanargmin(np.where(finite, fun_row, np.inf)))


def _fit_single_GP_MAP(gp, n_tries=15, theta0=None, method="L-BFGS-B", **kwargs):
    """Fit a single GP: all restarts as lanes of one minimization."""
    assert isinstance(gp, GaussianProcessBase)
    n_tries = int(n_tries)
    assert n_tries > 0, "number of attempts must be positive"
    _check_method(method)
    maxiter, gtol, ftol, race, ladder = _extract_opt_options(dict(kwargs))

    starts = _gather_starts(gp, n_tries, theta0)
    plan = _race_plan(n_tries, maxiter, race) or [(maxiter, None)]

    def run_schedule(ladder_mode):
        cur = gp._tensor(starts)
        for iters, keep in plan:
            lane0 = torch.zeros(cur.shape[0], dtype=torch.int64, device=cur.device)
            res = _minimize(cur, take_lanes(gp._data, lane0), gp.kernel, gp.nugget_type,
                            iters, gtol, ftol, ladder_mode)
            fun, xs = _host(res.fun), _host(res.x)
            if keep is not None:
                top = np.argsort(np.where(np.isfinite(fun), fun, np.inf))[:keep]
                cur = res.x[torch.as_tensor(top, device=cur.device)]
        return fun, xs

    fun, xs = run_schedule(ladder)
    if not np.isfinite(fun).any() and gp.nugget_type == "adaptive" and ladder is not False:
        # every start failed on the reduced trajectory ladder: retry the
        # whole schedule with the full ladder before declaring failure
        fun, xs = run_schedule(False)

    idx = _best(fun)
    if idx is None:
        print("Minimization routine failed to return a value")
        gp.theta = None
    else:
        gp.fit(xs[idx])
    return gp


def _minimize_outputs(ems, starts, maxiter, gtol, ftol, ladder, device):
    """One batched minimization of the outputs ``ems`` from ``starts``
    ``(g, T, P)`` on ``device``; returns ``(fun (g, T), xs (g, T, P))``."""
    g, T, P = starts.shape
    em0 = ems[0]
    data = to_device(cat_lanes([em._data for em in ems]), device)
    lanes = torch.arange(g, device=device).repeat_interleave(T)
    res = _minimize(torch.as_tensor(starts.reshape(-1, P), dtype=em0._dtype, device=device),
                    take_lanes(data, lanes), em0.kernel, em0.nugget_type, maxiter, gtol, ftol,
                    ladder)
    return _host(res.fun).reshape(-1, T), _host(res.x).reshape(-1, T, P)


def _run_fit_chunked(ems, starts, maxiter, gtol, ftol, ladder, mesh=None):
    """Minimize from ``starts`` ``(G, T, P)`` for the outputs ``ems`` (one
    signature group), in chunks of whole outputs under the memory budget of
    each device; with ``mesh``, a chunk's outputs are split over the mesh.

    :returns: ``(fun (G, T), xs (G, T, P))`` float64 numpy arrays.
    """
    G, T, P = starts.shape
    em0 = ems[0]
    n_dev = 1 if mesh is None else mesh.shape[mesh.axis_names[0]]
    per_chunk = max(1, _max_lanes(em0) // T) * n_dev
    fun = np.empty((G, T))
    xs = np.empty((G, T, P))
    for c0 in range(0, G, per_chunk):
        c1 = min(c0 + per_chunk, G)
        if mesh is None:
            fun[c0:c1], xs[c0:c1] = _minimize_outputs(ems[c0:c1], starts[c0:c1], maxiter, gtol,
                                                      ftol, ladder, em0._device)
            continue
        parts = [slice(c0 + p.start, c0 + p.stop) for p in split_rows(c1 - c0, n_dev)]
        results = map_shards(
            mesh, lambda k, d: _minimize_outputs(ems[parts[k]], starts[parts[k]], maxiter,
                                                 gtol, ftol, ladder, d),
            n_items=len(parts),
        )
        for part, (f, x) in zip(parts, results):
            fun[part], xs[part] = f, x
    return fun, xs


def _fit_MOGP_MAP(gp, n_tries=15, theta0=None, method="L-BFGS-B", refit=False, mesh=None,
                  **kwargs):
    """Fit the outputs of a MultiOutputGP, one batched schedule per
    signature group, split over ``mesh`` when it is given."""
    assert isinstance(gp, MultiOutputGP)
    n_tries = int(n_tries)
    assert n_tries > 0, "n_tries must be a positive integer"
    _check_method(method)
    maxiter, gtol, ftol, race, ladder = _extract_opt_options(dict(kwargs))

    if theta0 is None:
        theta0 = [None] * gp.n_emulators
    elif isinstance(theta0, np.ndarray):
        if theta0.ndim == 1:
            theta0 = [theta0] * gp.n_emulators
        else:
            assert theta0.ndim == 2, "theta0 must be a 1D or 2D array"
            assert theta0.shape[0] == gp.n_emulators, "bad shape for fitting starting points"
            theta0 = list(theta0)
    else:
        theta0 = list(theta0)
        assert len(theta0) == gp.n_emulators, "theta0 must be a list of length n_emulators"

    indices_to_fit = list(range(gp.n_emulators)) if refit else gp.get_indices_not_fit()
    if not indices_to_fit:
        return gp

    del last_phase_times[:]
    del pmesh.last_gathers[:]
    t_phase = time.perf_counter()

    def mark(label):
        nonlocal t_phase
        now = time.perf_counter()
        last_phase_times.append((label, now - t_phase))
        t_phase = now

    for rel_indices in gp._groups([gp.emulators[i] for i in indices_to_fit]).values():
        global_idx = [indices_to_fit[i] for i in rel_indices]
        ems = [gp.emulators[i] for i in global_idx]
        em0 = ems[0]
        starts = np.stack([_gather_starts(em, n_tries, theta0[i])
                           for em, i in zip(ems, global_idx)])  # (G, n_tries, P)
        G = len(ems)

        plan = _race_plan(n_tries, maxiter, race) or [(maxiter, None)]
        cur = starts
        for stage, (iters, keep) in enumerate(plan):
            fun, xs = _run_fit_chunked(ems, cur, iters, gtol, ftol, ladder, mesh)
            mark("stage{}".format(stage))
            if keep is not None:
                # the best `keep` restarts of each output run on;
                # non-finite restarts sort last
                order = np.argsort(np.where(np.isfinite(fun), fun, np.inf), axis=1)[:, :keep]
                cur = np.take_along_axis(xs, order[:, :, None], axis=1)

        # outputs with no finite restart: rerun from their starts with the
        # full ladder before declaring them unfit
        failed = [r for r in range(G) if not np.isfinite(fun[r]).any()]
        rescue = {}
        if failed and em0.nugget_type == "adaptive" and ladder is not False:
            fun_f, xs_f = _run_fit_chunked([ems[r] for r in failed], starts[failed],
                                           maxiter, gtol, ftol, False, mesh)
            for j, r in enumerate(failed):
                idx = _best(fun_f[j])
                if idx is not None:
                    rescue[r] = xs_f[j, idx]
            mark("rescue")

        fit_rows, best_raw = [], []
        for row, em in enumerate(ems):
            idx = _best(fun[row])
            if idx is not None:
                best_raw.append(xs[row, idx])
            elif row in rescue:
                best_raw.append(rescue[row])
            else:
                em.theta = None
                continue
            fit_rows.append(global_idx[row])
        # the winners' artifacts, with the full ladder, in batched gp_fit calls
        if mesh is None:
            gp._fit_lanes(fit_rows, best_raw)
        else:
            parts = split_rows(len(fit_rows), mesh.shape[mesh.axis_names[0]])
            for fits in map_shards(mesh, lambda k, d: gp._lane_artifacts(
                    fit_rows[parts[k]], best_raw[parts[k]], device=d), n_items=len(parts)):
                gp._install(fits)
        mark("refit")
    return gp


def fit_GP_MAP(*args, n_tries=15, theta0=None, method="L-BFGS-B", skip_failures=True,
               refit=False, mesh=None, **kwargs):
    """Fit one or more GPs by minimizing the negative log posterior.

    Takes a ``GaussianProcess`` or ``MultiOutputGP``, or the arguments of
    their constructors (``device=`` and ``dtype=`` included); runs
    ``n_tries`` restarts (the first from ``theta0`` when given, the rest
    from prior samples) and keeps the best finite result per output.

    Optimizer options in ``**kwargs``: ``maxiter`` (default 200),
    ``gtol`` / ``ftol`` (dtype-scaled defaults), ``race`` (default True,
    see ``_race_plan``) and ``opt_ladder`` (``"single"`` default,
    ``"sparse"`` or ``"full"``: the jitter ladder of the optimizer's
    trajectory under ``nugget="adaptive"``; the refit of each winner
    always uses the full ladder).  ``processes`` is accepted and ignored.

    A ``MultiOutputGP`` with ``refit=False`` fits only the outputs not fit
    yet.  Outputs that cannot be fit are reported (``skip_failures``) or
    raise ``RuntimeError``; a single GP that cannot be fit raises.

    ``mesh`` (a ``parallel.DeviceMesh``; anything else raises
    ``TypeError``) splits a ``MultiOutputGP``'s outputs over its devices,
    those of several processes included (see the module doc); a single GP
    ignores it with a warning, as in ``mogp_tpu``.
    """
    check_mesh(mesh, across_processes=True)
    if len(args) == 1:
        gp = args[0]
        if isinstance(gp, MultiOutputGP):
            gp = _fit_MOGP_MAP(gp, n_tries, theta0, method, refit, mesh, **kwargs)
        elif isinstance(gp, GaussianProcessBase):
            if mesh is not None:
                warnings.warn("mesh sharding applies to MultiOutputGP fits; ignoring mesh "
                              "for a single GP")
            gp = _fit_single_GP_MAP(gp, n_tries, theta0, method, **kwargs)
        else:
            raise TypeError(
                "single arg to fit_GP_MAP must be a GaussianProcess or MultiOutputGP instance"
            )
    elif len(args) < 2:
        raise TypeError("missing required inputs/targets arrays to GaussianProcess")
    else:
        gp_kwargs = {key: kwargs.pop(key) for key in _GP_KWARGS if key in kwargs}
        try:
            gp = GaussianProcess(*args, **gp_kwargs)
            gp = _fit_single_GP_MAP(gp, n_tries, theta0, method, **kwargs)
        except AssertionError:
            try:
                gp = MultiOutputGP(*args, **gp_kwargs)
                gp = _fit_MOGP_MAP(gp, n_tries, theta0, method, refit, mesh, **kwargs)
            except AssertionError:
                raise ValueError("Bad values for *args in fit_GP_MAP")

    if isinstance(gp, GaussianProcessBase):
        if gp.theta.get_data() is None:
            raise RuntimeError("GP fitting failed")
    elif gp.get_indices_not_fit():
        failure_string = "Fitting failed for emulators {}".format(gp.get_indices_not_fit())
        if skip_failures:
            print(failure_string)
        else:
            raise RuntimeError(failure_string)
    return gp
