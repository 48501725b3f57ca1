"""The plain reference agrees with the program in float64 on the CPU, so
that what it judges on the card is the program's precision and not a
difference of definitions; through the interface that the harness calls
(``pbcore/cells.py``) as through its own routines."""

import numpy as np
import pytest
import torch

import mogp_tpu_torch as mt
from pbcore import data
from reference import gp_ref as R


CPU = torch.device("cpu")
TSUNAMI = {"data": {"generator": "tsunami", "n_points": 40, "n_dim": 5, "n_outputs": 3}}


@pytest.fixture(scope="module")
def fitted():
    x, y = data.problem(TSUNAMI, 11)
    mgp = mt.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    np.random.seed(5)
    mt.fit_GP_MAP(mgp, n_tries=4, maxiter=30, refit=True)
    return x, y, mgp


def test_priors_and_log_posterior(fitted):
    x, y, mgp = fitted
    priors = R.default_corr_priors(x)
    _, a, b, _ = mgp.emulators[0].priors.packed()
    assert np.allclose(priors[:, 0], a[:5]) and np.allclose(priors[:, 1], b[:5])
    raw = torch.tensor(np.stack([em.theta.get_data() for em in mgp.emulators]))
    md = R.mean_diag(raw, torch.tensor(x)).numpy()
    rungs = [R.rung_of(em.nugget, m) for em, m in zip(mgp.emulators, md)]
    assert min(rungs) >= 0
    ref = R.nlp(raw, torch.tensor(x), torch.tensor(y), priors, rungs).numpy()
    logpost = [em.current_logpost for em in mgp.emulators]
    assert np.allclose(ref, logpost, rtol=1e-10)
    nuggets = np.array([em.nugget for em in mgp.emulators])
    allowed, judged = R.judge(raw.numpy(), nuggets, x, y, R.priors(x), CPU)
    assert allowed.all() and np.array_equal(judged, ref)
    own, at_own = R.own_fit(raw.numpy(), x, y, R.priors(x), CPU)
    assert np.allclose(own, nuggets, rtol=1e-12) and np.array_equal(at_own, ref)
    assert not R.judge(raw.numpy(), 3.0 * nuggets + 1e-3, x, y, priors, CPU)[0].any()


def test_implausibility(fitted):
    x, y, mgp = fitted
    q = np.random.RandomState(3).uniform(size=(300, 5))
    obs = [np.array([0.1, -0.2, 0.3]), np.array([0.02, 0.03, 0.04])]
    I = mt.HistoryMatching(gp=mgp, obs=obs, coords=q).get_implausibility(rank=1)
    raw = torch.tensor(np.stack([em.theta.get_data() for em in mgp.emulators]))
    md = R.mean_diag(raw, torch.tensor(x)).numpy()
    rungs = [R.rung_of(em.nugget, m) for em, m in zip(mgp.emulators, md)]
    mu, var = R.predict(raw, torch.tensor(x), torch.tensor(y), rungs, torch.tensor(q))
    ref = R.rank_implausibility(mu, var, torch.tensor(obs[0]), torch.tensor(obs[1]), 1).numpy()
    assert np.allclose(I, ref, rtol=1e-9)
    nuggets = np.array([em.nugget for em in mgp.emulators])
    assert np.array_equal(R.implausibility(raw.numpy(), nuggets, x, y, q, *obs, 1, CPU), ref)


def test_restart_points_are_the_programs(fitted):
    from mogp_tpu_torch.models.fitting import _gather_starts

    x, y, mgp = fitted
    np.random.seed(123)
    program = np.stack([_gather_starts(em, 7, None) for em in mgp.emulators])
    ref = R.restart_points(R.default_corr_priors(x), 3, 7, 123)
    assert np.array_equal(program, ref)


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-9, -3.0 - 2.0**-12])
    r = R.tf32_round(t)
    assert r.tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9, -3.0]
