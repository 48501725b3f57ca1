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

Spans (``utils/metrics.py``'s recorder): ``lbfgs.sync`` around each of
those questions, the host blocked on the device; ``lbfgs.grad`` around
the backward's enqueue.
"""

from typing import NamedTuple

import torch

from ..utils import metrics

__all__ = ["LBFGSResult", "lbfgs_minimize"]

# Per-iteration line-search trial cap.  Every lane pays for the batch's
# longest search in each iteration, so the cap multiplies the batched
# cost; a capped-out search does not end the lane, whose shrunken step
# warm-starts the next iteration (``mogp_tpu/ops/lbfgs.py:40-53``).
_DEF_MAX_LS = 2


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # (L, P) final iterates
    fun: torch.Tensor        # (L,) objective at x (NaN when failed)
    grad: torch.Tensor       # (L, P) gradient at x
    n_iter: torch.Tensor     # (L,) iterations taken
    converged: torch.Tensor  # (L,) gradient/function tolerance reached


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


def lbfgs_minimize(fun, x0, maxiter=200, gtol=None, ftol=None, memory=10,
                   max_linesearch=None, c1=1e-4):
    """Minimize ``fun`` from every row of ``x0`` with L-BFGS and a
    backtracking (Armijo) line search, lanes independent.

    :param fun: objective ``(L, P) -> (L,)``, differentiable by autograd.
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
    L, P = x0.shape
    dtype, device = x0.dtype, x0.device
    m = memory
    info = torch.finfo(dtype)
    if gtol is None:
        gtol = max(1e-5, 2.0 * info.eps**0.5)
    if ftol is None:
        ftol = max(1e-10, 10.0 * info.eps)
    collapse = 1e3 * info.tiny

    f, g = _value_and_grad(fun, x0)
    x = x0
    S = torch.zeros((L, m, P), dtype=dtype, device=device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((L, m), dtype=dtype, device=device)
    gamma = torch.ones(L, dtype=dtype, device=device)
    n_hist = torch.zeros(L, dtype=torch.int64, device=device)
    f_best = f
    stall = torch.zeros(L, dtype=torch.int64, device=device)
    t_prev = torch.ones(L, dtype=dtype, device=device)
    it = torch.zeros(L, dtype=torch.int64, device=device)
    done = ~(torch.isfinite(f) & torch.isfinite(g).all(dim=-1))
    converged = torch.zeros(L, dtype=torch.bool, device=device)

    while True:
        running = (it < maxiter) & ~done
        with metrics.span("lbfgs.sync"):
            go_on = bool(running.any())
        if not go_on:
            break

        d = _two_loop(g, S, Y, rho, gamma, n_hist)
        # not a descent direction: fall back to steepest descent
        d = torch.where((_dot(g, d) < 0)[:, None], d, -g)
        # no history: unit-length first step; otherwise the unit
        # quasi-Newton step; both capped at twice the last step
        d_norm = torch.linalg.vector_norm(d, dim=-1)
        first = torch.minimum(torch.ones_like(d_norm), 1.0 / torch.clamp_min(d_norm, 1e-30))
        t0 = torch.minimum(2.0 * t_prev, torch.where(n_hist == 0, first, 1.0))

        # line search; lanes stopped at its start count as accepted, so
        # they never search, and are reported as not accepted
        active = ~done
        gd = _dot(g, d)
        t, t_acc = t0, t0
        accepted = ~active
        xt, ft, gt = x, f, g
        for trial in range(max_linesearch):
            searching = ~accepted
            if trial:
                with metrics.span("lbfgs.sync"):
                    go_on = bool(searching.any())
                if not go_on:
                    break
            x_new = x + t[:, None] * d
            f_new, g_new = _value_and_grad(fun, x_new)
            armijo = f_new <= f + c1 * t * gd
            # accept only fully finite trials
            ok = torch.isfinite(f_new) & torch.isfinite(g_new).all(dim=-1) & armijo
            take = searching & ok
            xt = torch.where(take[:, None], x_new, xt)
            ft = torch.where(take, f_new, ft)
            gt = torch.where(take[:, None], g_new, gt)
            t_acc = torch.where(take, t, t_acc)
            # minimizer of the parabola through f, gd and f_new, kept in
            # [0.02 t, 0.5 t]; a non-finite trial shrinks 10x
            denom = 2.0 * (f_new - f - gd * t)
            t_q = -gd * t * t / torch.where(denom == 0.0, 1.0, denom)
            t_next = torch.minimum(torch.maximum(t_q, 0.02 * t), 0.5 * t)
            t_next = torch.where(torch.isfinite(f_new), t_next, 0.1 * t)
            t = torch.where(searching, t_next, t)
            accepted = torch.where(searching, ok, accepted)
        accepted = accepted & active

        s = xt - x
        y = gt - g
        sy = _dot(s, y)
        curv_ok = sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
        store = accepted & curv_ok
        new_S = _roll_in(S, s, store)
        new_Y = _roll_in(Y, y, store)
        new_rho = _roll_in(rho, 1.0 / sy, store)
        new_n_hist = torch.where(store, torch.clamp_max(n_hist + 1, m), n_hist)
        new_gamma = torch.where(store, sy / _dot(y, y), gamma)

        g_conv = torch.amax(torch.abs(gt), dim=-1) <= gtol
        f_conv = torch.abs(ft - f) <= ftol * torch.clamp_min(torch.abs(ft), 1.0)
        new_converged = accepted & (g_conv | f_conv)
        # stall: no significant improvement for 10 iterations; a capped-out
        # search keeps its shrunken step and stops only once it collapses
        improved = ft < f_best - ftol * torch.clamp_min(torch.abs(f_best), 1.0)
        new_f_best = torch.minimum(f_best, ft)
        new_stall = torch.where(improved, 0, stall + 1)
        t_carry = torch.where(accepted, t_acc, t)
        collapsed = ~accepted & (t_carry <= collapse)
        new_done = new_converged | collapsed | (new_stall >= 10)

        # a lane that is not running keeps its whole state
        r1, r2, r3 = running, running[:, None], running[:, None, None]
        x = torch.where(r2, xt, x)
        f = torch.where(running, ft, f)
        g = torch.where(r2, gt, g)
        S = torch.where(r3, new_S, S)
        Y = torch.where(r3, new_Y, Y)
        rho = torch.where(r2, new_rho, rho)
        gamma = torch.where(r1, new_gamma, gamma)
        n_hist = torch.where(r1, new_n_hist, n_hist)
        f_best = torch.where(r1, new_f_best, f_best)
        stall = torch.where(r1, new_stall, stall)
        t_prev = torch.where(r1, t_carry, t_prev)
        it = torch.where(r1, it + 1, it)
        done = torch.where(r1, new_done, done)
        converged = torch.where(r1, new_converged, converged)

    return LBFGSResult(x=x, fun=f, grad=g, n_iter=it, converged=converged)
