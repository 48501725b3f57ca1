"""The port's NUTS against the quadrature oracle of
``tests/test_inference.py``.

The oracle is ``mogp_tpu``'s own: a dense-grid quadrature of the float64
``gp_nlp`` of a two-parameter posterior (a noiseless 1-D GP with a fixed
nugget), computed by the JAX package as its test computes it (the
problem and the grid are ``chip_smoke.py``'s ``oracle_problem`` and
``oracle_grid``, which phase 7c runs on the card).  The port's chains must
land on its moments within the limits of the JAX package's test, with its
seeds.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import chip_smoke  # noqa: E402
import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.models import fitting as jfit  # noqa: E402
from mogp_tpu.models import gp as jgp  # noqa: E402
from mogp_tpu.models import priors as jpri  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402
from mogp_tpu_torch.models import priors as tpri  # noqa: E402

torch.set_num_threads(2)


def quadrature_oracle():
    """The quadrature moments (``tests/test_inference.py:164-217``) by
    ``mogp_tpu``, and the port's MAP fit of the same posterior."""
    gp = chip_smoke.oracle_problem(mogp_tpu, jpri)
    pts = chip_smoke.oracle_grid()
    nlp = jax.jit(jax.vmap(lambda r: jgp.gp_nlp(r, gp._data, gp.kernel, gp.nugget_type,
                                                sparse_ladder=jfit._OPT_LADDER)))(jnp.asarray(pts))
    mean_q, var_q, edge_mass = chip_smoke.quadrature_moments(pts, np.asarray(nlp))
    assert edge_mass < 1e-8, "quadrature grid does not contain the posterior"
    np.random.seed(0)
    tgp = mogp_tpu_torch.fit_GP_MAP(
        chip_smoke.oracle_problem(mogp_tpu_torch, tpri, device="cpu"), n_tries=4, maxiter=100)
    return tgp, mean_q, var_q


def test_nuts_posterior_matches_quadrature_oracle():
    gp, mean_q, var_q = quadrature_oracle()
    res = tinf.sample_GP_MCMC(gp, n_samples=1000, n_warmup=400, n_chains=4, seed=3,
                              theta0=gp.theta.get_data())
    assert np.all(res.rhat < 1.05)
    s = res.samples.reshape(-1, gp.n_params)
    # posterior means agree within 4x the Monte-Carlo standard error
    mcse = np.sqrt(var_q / np.maximum(res.ess, 1.0))
    assert np.all(np.abs(s.mean(0) - mean_q) < 4.0 * mcse + 1e-3)
    # posterior variances agree to ~MC accuracy (Var MCSE ~ var*sqrt(2/ess))
    assert_allclose(s.var(0), var_q, rtol=0.2)
