"""MAP hyperparameter estimation with the batched L-BFGS of ``ops/lbfgs.py``.

Port of ``mogp_tpu/models/fitting.py``.  Every (output, restart) pair is a
lane of one batched minimization of ``gp_nlp``; the outputs of a
``MultiOutputGP`` that share a configuration signature go through it
together, and a single GP is a group of one.  One schedule serves both
(``_fit_group``), the JAX package's:

* starts: ``theta0`` first when given, then prior samples from the host
  numpy RNG (``GPPriors.sample_n``), so a seeded fit starts where
  ``mogp_tpu`` does;
* the race: a short first stage on all restarts, then only the best
  quarter of each output's restarts runs on (``_race_plan``);
* the optimizer's trajectory factors with the one-rung ("single") jitter
  ladder under ``nugget="adaptive"``; an output whose every restart came
  out non-finite is run again with the full ladder before it is declared
  unfit (a single GP reruns its race, a ``MultiOutputGP`` output runs
  ``maxiter`` iterations without it, as in ``mogp_tpu``);
* the winner of each output is refit with the full ladder by the batched
  ``gp_fit`` (``MultiOutputGP._fit_lanes``).

On a card, at K2's sizes and on the one-rung ladder (``_graphed``), a
stage's lockstep L-BFGS runs from CUDA graphs, captured at the first stage
of its shapes and replayed at every later one (``ops/lbfgs.py``); the
rescue, the refit and the blocked route run eagerly.

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

Spans (``utils/metrics.py``'s recorder): ``fitting.fit_GP_MAP`` is the
root of each call, beneath it ``fitting.starts`` (the restart draws on
the host), ``fitting.stage`` (one per race stage), ``fitting.rescue`` and
``fitting.refit``; the last three also write ``last_phase_times``, whose
``stage0`` holds the draws too.
"""

import contextlib
import warnings

import numpy as np
import torch

from ..ops import cholesky_batched as kb
from ..ops.lbfgs import Capturable, lbfgs_minimize
from ..parallel import mesh as pmesh
from ..parallel.mesh import check_mesh, map_shards, split_rows, to_device
from ..utils import metrics
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

# (label, seconds) per phase of the last fit: "stage0", "stage1", ...,
# "rescue" and "refit", the seconds of the spans fitting.stage, .rescue and
# .refit, stage0's with the restart draws before it (fitting.starts); every
# phase ends with its results on the host, so the splits are device time too
last_phase_times = []


def _max_lanes(em):
    item = torch.finfo(em._dtype).bits // 8
    return max(1, _CHUNK_BYTES // (_LANE_MATRICES * em.n * em.n * item))


def _graphed(device_type, n, dtype, ladder, nugget_type):
    """Whether a stage's lockstep L-BFGS runs from CUDA graphs
    (``ops/lbfgs.py``): on a card, where K2 factors the (n, n) matrices,
    on the one-rung ("single") ladder, and not with the pivoted nugget.
    The rest stays eager: the blocked route's objective waits at syncs of
    its own, the sparse and full ladders make their rungs from host
    scalars, and the pivot search is a loop of n steps that no capture has
    been shown to take."""
    return (device_type == "cuda" and kb.route(n, dtype) == "k2" and ladder == "single"
            and nugget_type != "pivot")


def _minimize(starts, data, kernel, nugget_type, maxiter, gtol, ftol, ladder):
    """One batched L-BFGS over lanes: ``starts`` ``(L, P)``, ``data`` a
    ``GPData`` of ``L`` lanes; from CUDA graphs where :func:`_graphed`."""
    def nlp(raw, d):
        return gp_nlp(raw, d, kernel, nugget_type, sparse_ladder=ladder, progressive_ok=False)

    if _graphed(starts.device.type, data.inputs.shape[-2], starts.dtype, ladder, nugget_type):
        fun = Capturable(nlp, data, key=(kernel, nugget_type, ladder), span="gp.nlp")
    else:
        fun = lambda raw: nlp(raw, data)  # noqa: E731
    return lbfgs_minimize(fun, starts, maxiter=maxiter, gtol=gtol, ftol=ftol)


def _host(t):
    return t.to("cpu", torch.float64).numpy()


@contextlib.contextmanager
def _phase(kind, label, before=0.0, **attrs):
    """The span ``fitting.<kind>``, whose seconds, and ``before``'s, go to
    :data:`last_phase_times` under ``label``."""
    with metrics.timed_span("fitting." + kind, **attrs) as span:
        yield
    last_phase_times.append((label, before + span.seconds))


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


def _options(n_tries, method, kwargs):
    """The checked arguments of a fit: ``(n_tries, maxiter, gtol, ftol,
    ladder, plan)``, ``plan`` the race's stages or the one full stage."""
    n_tries = int(n_tries)
    assert n_tries > 0, "n_tries must be a positive integer"
    if method not in ("L-BFGS-B", "L-BFGS", "lbfgs"):
        warnings.warn(
            "method '{}' is not available on device; using batched L-BFGS".format(method)
        )
    kwargs = dict(kwargs)
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
    plan = _race_plan(n_tries, maxiter, race) or [(maxiter, None)]
    return n_tries, maxiter, gtol, ftol, ladder, plan


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


def _run_plan(ems, starts, plan, gtol, ftol, ladder, mesh, drawn=None):
    """The stages of ``plan`` from ``starts`` ``(G, T, P)``: after a stage
    with a ``keep``, the best ``keep`` restarts of each output run on.
    With ``drawn`` (the restart draws' seconds, which ``stage0`` holds too)
    each stage is a span ``fitting.stage``; the rescue's stages run inside
    its own span.  Returns the last stage's ``(fun, xs)``."""
    cur = starts
    for stage, (iters, keep) in enumerate(plan):
        with (contextlib.nullcontext() if drawn is None else
              _phase("stage", "stage{}".format(stage), drawn if stage == 0 else 0.0,
                     stage=stage)):
            fun, xs = _run_fit_chunked(ems, cur, iters, gtol, ftol, ladder, mesh)
            if keep is not None:
                # non-finite restarts sort last
                order = np.argsort(np.where(np.isfinite(fun), fun, np.inf), axis=1)[:, :keep]
                cur = np.take_along_axis(xs, order[:, :, None], axis=1)
    return fun, xs


def _best(fun_row, xs_row):
    """The raw vector of the smallest finite value, or ``None``."""
    finite = np.isfinite(fun_row)
    if not finite.any():
        return None
    return xs_row[int(np.nanargmin(np.where(finite, fun_row, np.inf)))]


def _fit_group(ems, theta0, n_tries, plan, rescue_plan, gtol, ftol, ladder, mesh=None):
    """The restart schedule of one signature group's outputs ``ems`` (a
    single GP is a group of one): the starts, ``theta0`` one entry an
    output, under the span ``fitting.starts``; the stages of ``plan``; the
    rescue, under ``fitting.rescue``: where a reduced ladder under
    ``nugget="adaptive"`` left an output no finite restart, it runs
    ``rescue_plan`` again from its starts on the full ladder; each output's
    winner.

    ``rescue_plan`` is where the callers differ, as in ``mogp_tpu``: a
    single GP reruns its race (``test_single_gp_escalation_reruns_the_schedule``),
    a MultiOutputGP runs ``[(maxiter, None)]``
    (``test_escalation_refits_failed_outputs_with_the_full_ladder``).

    :returns: each output's winning raw vector, or ``None``.
    """
    with metrics.timed_span("fitting.starts") as drawn:
        starts = np.stack([_gather_starts(em, n_tries, t) for em, t in zip(ems, theta0)])
    fun, xs = _run_plan(ems, starts, plan, gtol, ftol, ladder, mesh, drawn.seconds)
    won = [_best(f, x) for f, x in zip(fun, xs)]
    failed = [r for r, raw in enumerate(won) if raw is None]
    if failed and ems[0].nugget_type == "adaptive" and ladder is not False:
        with _phase("rescue", "rescue"):
            fun, xs = _run_plan([ems[r] for r in failed], starts[failed], rescue_plan, gtol,
                                ftol, False, mesh)
        for r, f, x in zip(failed, fun, xs):
            won[r] = _best(f, x)
    return won


def _fit_single_GP_MAP(gp, n_tries=15, theta0=None, method="L-BFGS-B", **kwargs):
    """Fit a single GP: its restarts are the lanes of a group of one."""
    assert isinstance(gp, GaussianProcessBase)
    n_tries, _, gtol, ftol, ladder, plan = _options(n_tries, method, kwargs)
    del last_phase_times[:]
    raw, = _fit_group([gp], [theta0], n_tries, plan, plan, gtol, ftol, ladder)
    with _phase("refit", "refit"):
        if raw is None:
            print("Minimization routine failed to return a value")
            gp.theta = None
        else:
            gp.fit(raw)
    return gp


def _fit_MOGP_MAP(gp, n_tries=15, theta0=None, method="L-BFGS-B", refit=False, mesh=None,
                  **kwargs):
    """Fit the outputs of a MultiOutputGP, one schedule per signature
    group, split over ``mesh`` when it is given."""
    assert isinstance(gp, MultiOutputGP)
    n_tries, maxiter, gtol, ftol, ladder, plan = _options(n_tries, method, kwargs)

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

    for rel_indices in gp._groups([gp.emulators[i] for i in indices_to_fit]).values():
        global_idx = [indices_to_fit[i] for i in rel_indices]
        won = _fit_group([gp.emulators[i] for i in global_idx], [theta0[i] for i in global_idx],
                         n_tries, plan, [(maxiter, None)], gtol, ftol, ladder, mesh)
        with _phase("refit", "refit"):
            fit_rows, best_raw = [], []
            for i, raw in zip(global_idx, won):
                if raw is None:
                    gp.emulators[i].theta = None
                else:
                    fit_rows.append(i)
                    best_raw.append(raw)
            # the winners' artifacts, with the full ladder, in batched gp_fit calls
            if mesh is None:
                gp._fit_lanes(fit_rows, best_raw)
            else:
                parts = split_rows(len(fit_rows), mesh.shape[mesh.axis_names[0]])
                for fits in map_shards(mesh, lambda k, d: gp._lane_artifacts(
                        fit_rows[parts[k]], best_raw[parts[k]], device=d), n_items=len(parts)):
                    gp._install(fits)
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
    with metrics.span("fitting.fit_GP_MAP"):
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
