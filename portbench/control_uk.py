"""The readings of the ``ukriging64`` cells' limits (not part of a benchmark run).

    python3 portbench/control_uk.py --workload W --seconds T --seeds 1,2,3 --mode MODE

``control.py`` with three more faults of the program (planted under the
timed path, in this process only); the first two leave out part of the
mean's mathematics:

* ``logdet_A_left_out``: the negative log posterior without ``log det A``,
  in the objective and in the fit's reported value;
* ``B_inv_left_out``: the mean's prior precision ``B^-1`` left out of ``A =
  H^T K^-1 H + B^-1``, in the objective, the mean coefficients and the
  prediction;
* ``state_unchanged``: ``faults.unchanged`` for an objective that runs
  from CUDA graphs too: the optimizer's step returns its state unchanged
  (``faults.unchanged`` calls the objective, which a graphed one, an
  ``ops.lbfgs.Capturable``, is not).
"""

import sys

import control

from pbcore import faults


def logdet_A_left_out():
    """The negative log posterior without ``0.5 log det A``."""
    from mogp_tpu_torch.models import gp

    nlp = gp.marginal_nlp

    def without(core, Kinv, mean_logdet_cov, n_coeff):
        return nlp(core, Kinv, mean_logdet_cov, n_coeff) - 0.5 * core.Ainv.logdet()

    gp.marginal_nlp = without


def B_inv_left_out():
    """``A = H^T K^-1 H``: the prior precision of the mean left out."""
    import torch

    from mogp_tpu_torch.models import gp

    core = gp.marginal_core

    def without(Kinv, dm, resid, mean_inv_cov):
        return core(Kinv, dm, resid, torch.zeros_like(mean_inv_cov))

    gp.marginal_core = without


def state_unchanged():
    """Every restart ends where it started, graphed objective or not."""
    import torch

    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.ops.lbfgs import Capturable, LBFGSResult

    def still(fun, x0, maxiter=200, gtol=None, ftol=None, **kw):
        with torch.no_grad():
            f = fun.fn(x0, fun.args) if isinstance(fun, Capturable) else fun(x0)
        return LBFGSResult(x=x0, fun=f, grad=torch.zeros_like(x0),
                           n_iter=torch.zeros(len(x0), dtype=torch.int64, device=x0.device),
                           converged=torch.ones(len(x0), dtype=torch.bool, device=x0.device))

    fitting.lbfgs_minimize = still


FAULTS = {"logdet_A_left_out": logdet_A_left_out, "B_inv_left_out": B_inv_left_out,
          "state_unchanged": state_unchanged}

if __name__ == "__main__":
    faults.FAULTS.update(FAULTS)
    sys.exit(control.main(sys.argv[1:]))
