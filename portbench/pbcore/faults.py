"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_portbench_faults.py``) and to read the numbers they give
on the card (``control.py --mode``).  Nothing in a benchmark run calls
these: each replaces a function of the program in this process only.
"""


def unchanged():
    """The optimizer's step returns its state unchanged: every restart
    ends where it started."""
    import torch

    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.ops.lbfgs import LBFGSResult

    def still(fun, x0, maxiter=200, gtol=None, ftol=None, **kw):
        with torch.no_grad():
            f = fun(x0)
        return LBFGSResult(x=x0, fun=f, grad=torch.zeros_like(x0),
                           n_iter=torch.zeros(len(x0), dtype=torch.int64, device=x0.device),
                           converged=torch.ones(len(x0), dtype=torch.bool, device=x0.device))

    fitting.lbfgs_minimize = still


def wrong_gradient():
    """The Cholesky's reverse rule broken: it returns its gradient with the
    sign turned, so the optimizer is steered by a wrong gradient while every
    value it reads is right."""
    from mogp_tpu_torch.ops import cholesky

    rule = cholesky._chol_bwd

    def turned(L, L_bar):
        return -rule(L, L_bar)

    cholesky._chol_bwd = turned


def starts_drawn_otherwise():
    """The restart points drawn otherwise than mogp-emulator draws them (the
    host's stream moved on by one number first), as a change that moved
    the draws would leave them: the fit is sound, but the numbers that rest
    on the reference redrawing them no longer see the program's starts."""
    import numpy as np

    from mogp_tpu_torch.models import fitting

    gather = fitting._gather_starts

    def moved(gp, n_tries, theta0):
        np.random.rand()
        return gather(gp, n_tries, theta0)

    fitting._gather_starts = moved


def half_left_out():
    """Half of the batch left out: the minimization drops the second half
    of its outputs (a fit of several outputs), or half of the query points
    come back as zeros (a sweep)."""
    import numpy as np

    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.uq.history_matching import HistoryMatching

    minimize = fitting._run_fit_chunked

    def half_fit(ems, starts, *args, **kw):
        fun, xs = minimize(ems, starts, *args, **kw)
        fun[max(1, len(ems) // 2):] = np.nan
        return fun, xs

    sweep = HistoryMatching._sweep_topk

    def half_sweep(self, coords, disc_full, k, device=None):
        out = sweep(self, coords[:len(coords) // 2], disc_full, k, device)
        return np.concatenate([out, np.zeros((out.shape[0], len(coords) - out.shape[1]))], 1)

    fitting._run_fit_chunked = half_fit
    HistoryMatching._sweep_topk = half_sweep


def altered():
    """An answer altered where it is produced: each fitted emulator's log
    posterior is off by one nat, each implausibility by one part in a
    hundred."""
    from mogp_tpu_torch.models.gp import GaussianProcess
    from mogp_tpu_torch.uq import history_matching

    install = GaussianProcess._set_fit_artifacts

    def off_by_one(self, raw, arts, summary):
        install(self, raw, arts, summary)
        self.current_logpost += 1.0

    topk = history_matching._implausibility_topk

    def scaled(tiles, obs_mean, obs_var, k):
        return 1.01 * topk(tiles, obs_mean, obs_var, k)

    GaussianProcess._set_fit_artifacts = off_by_one
    history_matching._implausibility_topk = scaled


def exchange_left_out():
    """The exchange between processes left out of the refit: each process
    installs the winners of its own outputs only."""
    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.parallel import mesh as pmesh

    gather = fitting.map_shards

    def lonely(mesh, fn, n_items=None):
        results = gather(mesh, fn, n_items)
        owners = mesh.shard_processes()
        me = pmesh.process_index()
        return [r if owners[k] == me or not isinstance(r, list) else []
                for k, r in enumerate(results)]

    fitting.map_shards = lonely


FAULTS = {"unchanged": unchanged, "wrong_gradient": wrong_gradient,
          "starts_drawn_otherwise": starts_drawn_otherwise, "half_left_out": half_left_out, "altered": altered,
          "exchange_left_out": exchange_left_out}
