"""End-to-end integration test of the port: the full tutorial UQ workflow.

The port of ``tests/test_tutorial_integration.py`` (design -> simulate ->
fit -> validate -> history-match -> NUTS -> SMC) on ``device="cpu"``, with
its seeds and assertions: the workflow of ``SURVEY.md`` through
``mogp_tpu_torch`` alone.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models.inference import sample_GP_MCMC  # noqa: E402
from mogp_tpu_torch.uq.smc import smc_history_match  # noqa: E402
from mogp_tpu_torch.uq.validation import mahalanobis, standard_errors  # noqa: E402

torch.set_num_threads(2)


def simulator(x):
    return float(np.exp(-x[0] ** 2) * np.sin(3 * x[1]) + 0.5 * x[1])


def test_full_tutorial_flow():
    np.random.seed(77)
    bounds = [(-2.0, 2.0), (0.0, 3.0)]

    # 1. design + simulate
    lhd = mogp_tpu_torch.LatinHypercubeDesign(bounds)
    inputs = lhd.sample(35)
    targets = np.array([simulator(p) for p in inputs])

    # 2. fit
    gp = mogp_tpu_torch.GaussianProcess(inputs, targets, nugget="fit", device="cpu")
    gp = mogp_tpu_torch.fit_GP_MAP(gp, n_tries=5)
    assert np.isfinite(gp.current_logpost)

    # 3. validate: held-out errors should be mostly within a few sigma
    xv = lhd.sample(12)
    yv = np.array([simulator(p) for p in xv])
    errors, order = standard_errors(gp, xv, yv)
    assert np.mean(np.abs(errors) < 4.0) > 0.7
    M = mahalanobis(gp, xv, yv)
    assert np.isfinite(M) and M >= 0.0

    # 4. history matching: truth points must survive
    obs_point = np.array([0.3, 1.2])
    obs_value = simulator(obs_point)
    query = lhd.sample(2000)
    query = np.vstack([query, obs_point])
    hm = mogp_tpu_torch.HistoryMatching(gp=gp, coords=query, obs=[obs_value, 1e-4])
    nroy = hm.get_NROY()
    assert len(nroy) > 0
    assert len(query) - 1 in nroy or hm.I[-1] < 4.0  # the truth survives

    # 5. full posterior: chains mix
    mcmc = sample_GP_MCMC(
        gp, n_samples=100, n_warmup=150, n_chains=2,
        theta0=gp.theta.get_data(), seed=0,
    )
    assert np.all(np.isfinite(mcmc.samples))
    assert np.all(mcmc.rhat < 1.5)

    # 6. SMC concentrates on consistent inputs
    smc = smc_history_match(
        gp, obs=[obs_value, 1e-4], bounds=bounds,
        n_particles=512, n_stages=5, n_mcmc=2, seed=1,
    )
    assert smc.nroy_fraction > 0.8
    # the SMC particles should predict values close to the observation
    mu, _, _ = gp.predict(smc.particles[:200])
    assert np.mean(np.abs(mu - obs_value) < 0.3) > 0.8
