"""Batched L-BFGS over a leading lanes axis.

Port of ``mogp_tpu/ops/lbfgs.py``.  The JAX package writes the minimizer
for one start and ``vmap``s it over (output x restart) lanes; here the
lanes are the first axis of every tensor, and each lane follows exactly
what ``jax.vmap(lbfgs_minimize)`` does to it:

* the outer loop runs while any lane runs; a lane that has stopped
  (converged, stalled, collapsed step, non-finite start, or ``maxiter``)
  keeps its whole state, its iteration count included;
* the line search runs while any lane is still searching; a lane that has
  accepted a trial, or was stopped when the search began, is never
  overwritten by a later trial;
* step lengths, trial counts, the history and every test are per lane.

The loop asks the device one question per outer iteration and one per
line-search trial after the first -- is any lane still running? -- and
reads nothing else back.  The objective ``fun(x)`` maps ``(L, P)`` to
``(L,)``; its gradient is ``torch.autograd.grad(fun(x).sum(), x)``, which
keeps lanes independent: a lane whose objective is NaN touches no other.

**Segments.**  Between two of those questions the loop enqueues work of
fixed shape: the direction, each line-search trial (the objective's value
and gradient at ``x + t d``, then the trial's bookkeeping) and the state
update.  :class:`_Lockstep` holds the state in tensors written in place
and each segment as a method; one host loop, :func:`_drive`, runs them in
one of two ways:

* eagerly, each segment enqueued as it is called: a plain callable
  objective, and any objective on the CPU;
* from CUDA graphs, for a :class:`Capturable` objective on a card
  (:func:`_run_graphed`): each segment, and the objective's value and
  gradient, is captured once (``ops/graphs.py``) and replayed at every later call with the same
  shapes and options.  The captured lockstep is cached by what the graphs
  bake in, :data:`GRAPH_CACHE_SIZE` of them on each device, the least
  recently used of that device dropped first; each holds its graphs'
  memory until it is dropped (:func:`clear_graphs`).

Both run the same tensor operations on the same values.

Spans and counters (``utils/metrics.py``'s recorder): ``lbfgs.sync``
around each of those questions, the host blocked on the device;
``lbfgs.grad`` around the eager backward's enqueue, and the capturable
objective's own span (``Capturable.span``) around each replay of its
graph; ``lbfgs.evals_eager`` and ``lbfgs.evals_graphed``, the lanes of each
value and gradient run eagerly (a capture's warm-ups included) and from a
graph.
"""

import collections
import threading
from typing import Callable, Hashable, NamedTuple

import torch

from ..utils import metrics
from . import graphs

__all__ = ["LBFGSResult", "Capturable", "lbfgs_minimize", "clear_graphs", "GRAPH_CACHE_SIZE"]

# Per-iteration line-search trial cap.  Every lane pays for the batch's
# longest search in each iteration, so the cap multiplies the batched
# cost; a capped-out search does not end the lane, whose shrunken step
# warm-starts the next iteration (``mogp_tpu/ops/lbfgs.py:40-53``).
_DEF_MAX_LS = 2

# captured locksteps kept on each device: a fit's race stages take one each
# on every card they run on (two for a 64-output fit, on each card of a
# mesh), and each holds a graph pool of the objective's intermediates
# (~9.5 (n, n) matrices a lane)
GRAPH_CACHE_SIZE = 4


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # (L, P) final iterates
    fun: torch.Tensor        # (L,) objective at x (NaN when failed)
    grad: torch.Tensor       # (L, P) gradient at x
    n_iter: torch.Tensor     # (L,) iterations taken
    converged: torch.Tensor  # (L,) gradient/function tolerance reached


class Capturable(NamedTuple):
    """An objective that may run from CUDA graphs: ``fn(x, args)`` maps
    ``(L, P)`` to ``(L,)``, reading the tensors of the tuple (or
    NamedTuple) ``args``, which each call copies into the capture's own;
    nothing in it may copy from the host or read the device.  ``key`` names
    everything else that ``fn`` bakes into a capture; ``span`` is the span
    recorded around each replay of its value and gradient."""

    fn: Callable
    args: tuple
    key: Hashable
    span: str


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _value_and_grad(fun, x):
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        f = fun(x)
        with metrics.span("lbfgs.grad"):
            (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _two_loop(g, S, Y, rho, gamma, n_hist):
    """Two-loop recursion giving the quasi-Newton direction ``-H g`` per
    lane.  The history is ordered (slot m-1 newest); slots below ``m -
    n_hist`` hold no pair yet and are masked."""
    m = S.shape[1]
    valid = torch.arange(m, device=g.device) >= (m - n_hist)[:, None]  # (L, m)
    q = g
    alphas = [None] * m
    for k in reversed(range(m)):
        alphas[k] = torch.where(valid[:, k], rho[:, k] * _dot(S[:, k], q), 0.0)
        q = q - alphas[k][:, None] * Y[:, k]
    r = gamma[:, None] * q
    for k in range(m):
        beta = torch.where(valid[:, k], rho[:, k] * _dot(Y[:, k], r), 0.0)
        r = r + (alphas[k] - beta)[:, None] * S[:, k] * valid[:, k, None].to(r.dtype)
    return -r


def _roll_in(buf, new, store):
    """Drop the oldest slot, append ``new`` as the newest, where ``store``."""
    rolled = torch.cat([buf[:, 1:], new[:, None]], dim=1)
    mask = store.reshape(-1, *([1] * (buf.ndim - 1)))
    return torch.where(mask, rolled, buf)


class _Lockstep:
    """The state of one lockstep minimization of ``L`` lanes of ``P``
    parameters, in tensors that every segment writes in place, and the
    segments.  The objective's argument is ``x_in``; its value and
    gradient go to ``f_in`` and ``g_in``.  ``running_any`` and
    ``searching_any`` are the flags the host reads."""

    def __init__(self, L, P, dtype, device, memory, gtol, ftol, c1):
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.m, self.gtol, self.ftol, self.c1 = memory, gtol, ftol, c1
        self.collapse = 1e3 * torch.finfo(dtype).tiny
        i64, b = torch.int64, torch.bool
        self.maxiter = z(dt=i64)
        self.x_in, self.f_in, self.g_in = z(L, P), z(L), z(L, P)
        # the iterate, its history and tests
        self.x, self.f, self.g = z(L, P), z(L), z(L, P)
        self.S, self.Y, self.rho = z(L, memory, P), z(L, memory, P), z(L, memory)
        self.gamma, self.n_hist = z(L), z(L, dt=i64)
        self.f_best, self.stall, self.t_prev = z(L), z(L, dt=i64), z(L)
        self.it, self.done, self.converged = z(L, dt=i64), z(L, dt=b), z(L, dt=b)
        self.running, self.running_any = z(L, dt=b), z(dt=b)
        # an iteration's direction and line search
        self.d, self.gd, self.active = z(L, P), z(L), z(L, dt=b)
        self.t, self.t_acc, self.accepted = z(L), z(L), z(L, dt=b)
        self.xt, self.ft, self.gt = z(L, P), z(L), z(L, P)
        self.searching_any = z(dt=b)

    def evaluate(self, fun):
        """The objective's value and gradient at ``x_in``."""
        f, g = _value_and_grad(fun, self.x_in)
        self.f_in.copy_(f)
        self.g_in.copy_(g)

    def start(self):
        """A fresh state at ``x_in``, from the objective there."""
        f, g = self.f_in, self.g_in
        self.x.copy_(self.x_in)
        self.f.copy_(f)
        self.g.copy_(g)
        for buf in (self.S, self.Y, self.rho, self.n_hist, self.stall, self.it, self.converged):
            buf.zero_()
        self.gamma.fill_(1.0)
        self.t_prev.fill_(1.0)
        self.f_best.copy_(f)
        self.done.copy_(~(torch.isfinite(f) & torch.isfinite(g).all(dim=-1)))
        self._flag_running()

    def _flag_running(self):
        self.running.copy_((self.it < self.maxiter) & ~self.done)
        self.running_any.copy_(self.running.any())

    def direction(self):
        """The search direction and first step length; the line search
        set up, and its first point in ``x_in``."""
        g = self.g
        d = _two_loop(g, self.S, self.Y, self.rho, self.gamma, self.n_hist)
        # not a descent direction: fall back to steepest descent
        d = torch.where((_dot(g, d) < 0)[:, None], d, -g)
        # no history: unit-length first step; otherwise the unit
        # quasi-Newton step; both capped at twice the last step
        d_norm = torch.linalg.vector_norm(d, dim=-1)
        first = torch.minimum(torch.ones_like(d_norm), 1.0 / torch.clamp_min(d_norm, 1e-30))
        t0 = torch.minimum(2.0 * self.t_prev, torch.where(self.n_hist == 0, first, 1.0))
        self.d.copy_(d)
        self.gd.copy_(_dot(g, d))
        # lanes stopped at the search's start count as accepted, so they
        # never search, and are reported as not accepted
        self.active.copy_(~self.done)
        self.t.copy_(t0)
        self.t_acc.copy_(t0)
        self.accepted.copy_(~self.active)
        self.xt.copy_(self.x)
        self.ft.copy_(self.f)
        self.gt.copy_(self.g)
        self._trial_point()

    def _trial_point(self):
        self.x_in.copy_(self.x + self.t[:, None] * self.d)
        self.searching_any.copy_((~self.accepted).any())

    def trial(self):
        """A line-search trial's bookkeeping, from the objective at
        ``x_in``; then the next trial's point."""
        x_new, f_new, g_new = self.x_in, self.f_in, self.g_in
        f, gd, t = self.f, self.gd, self.t
        searching = ~self.accepted
        armijo = f_new <= f + self.c1 * t * gd
        # accept only fully finite trials
        ok = torch.isfinite(f_new) & torch.isfinite(g_new).all(dim=-1) & armijo
        take = searching & ok
        self.xt.copy_(torch.where(take[:, None], x_new, self.xt))
        self.ft.copy_(torch.where(take, f_new, self.ft))
        self.gt.copy_(torch.where(take[:, None], g_new, self.gt))
        self.t_acc.copy_(torch.where(take, t, self.t_acc))
        # minimizer of the parabola through f, gd and f_new, kept in
        # [0.02 t, 0.5 t]; a non-finite trial shrinks 10x
        denom = 2.0 * (f_new - f - gd * t)
        t_q = -gd * t * t / torch.where(denom == 0.0, 1.0, denom)
        t_next = torch.minimum(torch.maximum(t_q, 0.02 * t), 0.5 * t)
        t_next = torch.where(torch.isfinite(f_new), t_next, 0.1 * t)
        self.t.copy_(torch.where(searching, t_next, t))
        self.accepted.copy_(torch.where(searching, ok, self.accepted))
        self._trial_point()

    def update(self):
        """The iteration's end: the history, the tests and the new state
        of every running lane; then which lanes run on."""
        x, f, g, xt, ft, gt = self.x, self.f, self.g, self.xt, self.ft, self.gt
        accepted = self.accepted & self.active
        m, ftol = self.m, self.ftol

        s = xt - x
        y = gt - g
        sy = _dot(s, y)
        norm = torch.linalg.vector_norm
        curv_ok = sy > 1e-10 * norm(s, dim=-1) * norm(y, dim=-1)
        store = accepted & curv_ok
        new_S = _roll_in(self.S, s, store)
        new_Y = _roll_in(self.Y, y, store)
        new_rho = _roll_in(self.rho, 1.0 / sy, store)
        new_n_hist = torch.where(store, torch.clamp_max(self.n_hist + 1, m), self.n_hist)
        new_gamma = torch.where(store, sy / _dot(y, y), self.gamma)

        g_conv = torch.amax(torch.abs(gt), dim=-1) <= self.gtol
        f_conv = torch.abs(ft - f) <= ftol * torch.clamp_min(torch.abs(ft), 1.0)
        new_converged = accepted & (g_conv | f_conv)
        # stall: no significant improvement for 10 iterations; a capped-out
        # search keeps its shrunken step and stops only once it collapses
        f_best = self.f_best
        improved = ft < f_best - ftol * torch.clamp_min(torch.abs(f_best), 1.0)
        new_f_best = torch.minimum(f_best, ft)
        new_stall = torch.where(improved, 0, self.stall + 1)
        t_carry = torch.where(accepted, self.t_acc, self.t)
        collapsed = ~accepted & (t_carry <= self.collapse)
        new_done = new_converged | collapsed | (new_stall >= 10)

        # a lane that is not running keeps its whole state
        running = self.running
        r1, r2, r3 = running, running[:, None], running[:, None, None]
        for buf, mask, new in ((x, r2, xt), (f, r1, ft), (g, r2, gt), (self.S, r3, new_S),
                               (self.Y, r3, new_Y), (self.rho, r2, new_rho),
                               (self.gamma, r1, new_gamma), (self.n_hist, r1, new_n_hist),
                               (f_best, r1, new_f_best), (self.stall, r1, new_stall),
                               (self.t_prev, r1, t_carry), (self.it, r1, self.it + 1),
                               (self.done, r1, new_done), (self.converged, r1, new_converged)):
            buf.copy_(torch.where(mask, new, buf))
        self._flag_running()

    def result(self):
        return LBFGSResult(x=self.x.clone(), fun=self.f.clone(), grad=self.g.clone(),
                           n_iter=self.it.clone(), converged=self.converged.clone())


class _Steps(NamedTuple):
    """How :func:`_drive` runs each segment of a :class:`_Lockstep`, and the
    counter of the objective's lane-evaluations."""

    objective: Callable
    start: Callable
    direction: Callable
    trial: Callable
    update: Callable
    evals: str


def _drive(ls, steps, maxiter, max_linesearch):
    """The host loop: from the point in ``ls.x_in``, run ``steps`` until no
    lane runs."""
    lanes = ls.x.shape[0]

    def objective():
        steps.objective()
        metrics.count(steps.evals, lanes)

    ls.maxiter.fill_(maxiter)
    objective()
    steps.start()
    while True:
        with metrics.span("lbfgs.sync"):
            go_on = bool(ls.running_any)
        if not go_on:
            break
        steps.direction()
        for trial in range(max_linesearch):
            if trial:
                with metrics.span("lbfgs.sync"):
                    go_on = bool(ls.searching_any)
                if not go_on:
                    break
            objective()
            steps.trial()
        steps.update()
    return ls.result()


class _Captured:
    """A lockstep captured for one key: its state, its own copies of the
    objective's arguments, and the graphs of its segments."""

    def __init__(self, obj, x0, memory, gtol, ftol, c1):
        L, P = x0.shape
        self.lock = threading.Lock()
        ls = self.ls = _Lockstep(L, P, x0.dtype, x0.device, memory, gtol, ftol, c1)
        ls.x_in.copy_(x0)
        args = [a.clone() for a in obj.args]
        self.args = obj.args._make(args) if hasattr(obj.args, "_make") else tuple(args)
        fn, span = obj.fn, obj.span

        def evaluate():
            ls.evaluate(lambda x: fn(x, self.args))

        made = {name: graphs.capture(seg, x0.device)[0]
                for name, seg in (("objective", evaluate), ("start", ls.start),
                                  ("direction", ls.direction), ("trial", ls.trial),
                                  ("update", ls.update))}
        metrics.count("lbfgs.evals_eager", graphs.WARMUPS * L)
        value_and_grad = made["objective"]

        def objective():
            with metrics.span(span):
                value_and_grad.replay()

        self.steps = _Steps(objective, made["start"].replay, made["direction"].replay,
                            made["trial"].replay, made["update"].replay, "lbfgs.evals_graphed")

    def load(self, args, x0):
        for mine, a in zip(self.args, args):
            mine.copy_(a)
        self.ls.x_in.copy_(x0)


# device -> {key: _Captured}, least recently used first
_graph_cache = collections.defaultdict(collections.OrderedDict)
_cache_lock = threading.Lock()


def _captured(device, key, build):
    """The cached lockstep of ``key`` on ``device``, made by ``build()``
    if there is none; beyond :data:`GRAPH_CACHE_SIZE` on that device, its
    least recently used is dropped.  Each device has its own bound, so the
    shards of a mesh over several cards evict none of each other's."""
    with _cache_lock:
        cache = _graph_cache[device]
        entry = cache.get(key)
        if entry is not None:
            cache.move_to_end(key)
            return entry
    entry = build()
    with _cache_lock:
        cache[key] = entry
        while len(cache) > GRAPH_CACHE_SIZE:
            cache.popitem(last=False)
    return entry


def _entries():
    """Every cached lockstep, on every device."""
    with _cache_lock:
        return [e for cache in _graph_cache.values() for e in cache.values()]


def clear_graphs():
    """Drop every captured lockstep, and with them their graphs' memory
    (back to the device at ``torch.cuda.empty_cache()``)."""
    with _cache_lock:
        _graph_cache.clear()


def _run_graphed(obj, x0, maxiter, gtol, ftol, memory, max_linesearch, c1):
    """:func:`_drive` from the graphs of the lockstep that ``obj`` and the
    options make, captured at the first call with this key."""
    key = (x0.dtype, tuple(x0.shape), memory, gtol, ftol, c1, obj.key,
           tuple((tuple(a.shape), a.dtype) for a in obj.args))
    entry = _captured(x0.device, key, lambda: _Captured(obj, x0, memory, gtol, ftol, c1))
    with entry.lock:
        entry.load(obj.args, x0)
        return _drive(entry.ls, entry.steps, maxiter, max_linesearch)


def _tolerances(dtype, gtol=None, ftol=None):
    """``(gtol, ftol)``, each the dtype's default where ``None``:
    ``max(1e-5, 2 sqrt(eps))`` and ``max(1e-10, 10 eps)``."""
    info = torch.finfo(dtype)
    if gtol is None:
        gtol = max(1e-5, 2.0 * info.eps**0.5)
    if ftol is None:
        ftol = max(1e-10, 10.0 * info.eps)
    return gtol, ftol


def lbfgs_minimize(fun, x0, maxiter=200, gtol=None, ftol=None, memory=10,
                   max_linesearch=None, c1=1e-4):
    """Minimize ``fun`` from every row of ``x0`` with L-BFGS and a
    backtracking (Armijo) line search, lanes independent.

    :param fun: objective ``(L, P) -> (L,)``, differentiable by autograd;
        or a :class:`Capturable`, which runs from CUDA graphs where ``x0``
        is on a card and eagerly elsewhere.
    :param x0: starting points ``(L, P)``.
    :param gtol: inf-norm gradient tolerance; ``None`` selects ``max(1e-5,
        2 sqrt(eps))`` of the dtype.
    :param ftol: relative objective-change tolerance; ``None`` selects
        ``max(1e-10, 10 eps)``.
    :param max_linesearch: trials per iteration (default 2).
    :param c1: Armijo constant.  There is no Wolfe curvature test: pairs
        with too little positive curvature are not stored instead.
    :returns: ``LBFGSResult`` with per-lane fields.
    """
    if max_linesearch is None:
        max_linesearch = _DEF_MAX_LS
    x0 = x0.detach()
    gtol, ftol = _tolerances(x0.dtype, gtol, ftol)
    if isinstance(fun, Capturable):
        if x0.device.type == "cuda":
            return _run_graphed(fun, x0, maxiter, gtol, ftol, memory, max_linesearch, c1)
        fn, args = fun.fn, fun.args
        fun = lambda x: fn(x, args)  # noqa: E731
    ls = _Lockstep(*x0.shape, x0.dtype, x0.device, memory, gtol, ftol, c1)
    ls.x_in.copy_(x0)
    steps = _Steps(lambda: ls.evaluate(fun), ls.start, ls.direction, ls.trial, ls.update,
                   "lbfgs.evals_eager")
    return _drive(ls, steps, maxiter, max_linesearch)
