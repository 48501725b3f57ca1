"""The port's NUTS over GP hyperparameters: the statistical ports of
``tests/test_inference.py`` (same data, seeds and assertions; the random
streams are the port's own), and the chains of a ``MultiOutputGP``'s
outputs, which are those of each output's own GP."""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fit_gp():
    np.random.seed(3)
    x = np.random.rand(25, 2) * 2
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * np.random.randn(25)
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cpu")
    return mogp_tpu_torch.fit_GP_MAP(gp, n_tries=4)


def _small_gp(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, size=(n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] if n > 12 else np.sin(2 * x[:, 0])
    np.random.seed(0)
    return mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cpu"), n_tries=2,
        maxiter=40 if n > 12 else 30)


def test_gp_mcmc_agrees_with_map(fit_gp):
    res = tinf.sample_GP_MCMC(fit_gp, n_samples=200, n_warmup=200, n_chains=2, seed=0,
                              theta0=fit_gp.theta.get_data())
    assert res.samples.shape == (2, 200, fit_gp.n_params)
    assert np.all(res.rhat < 1.2)
    post_mean = res.samples.reshape(-1, fit_gp.n_params).mean(axis=0)
    # posterior mean should be in the vicinity of the MAP
    assert np.all(np.abs(post_mean - fit_gp.theta.get_data()) < 2.0)


def test_predict_mcmc(fit_gp):
    res = tinf.sample_GP_MCMC(fit_gp, n_samples=100, n_warmup=200, n_chains=2, seed=1,
                              theta0=fit_gp.theta.get_data())
    xt = np.random.RandomState(5).rand(6, 2) * 2
    yt = np.sin(3 * xt[:, 0]) * np.cos(2 * xt[:, 1])
    mu, var = tinf.predict_MCMC(fit_gp, res.samples, xt, thin=5)
    assert mu.shape == (6,)
    assert np.all(var > 0)
    # posterior predictive should be roughly calibrated
    z = np.abs(mu - yt) / np.sqrt(var)
    assert np.all(z < 5.0)


def test_mogp_chains_are_those_of_each_output():
    """An output's chains in a ``MultiOutputGP`` batch are the chains of its
    own ``GaussianProcess`` started from the same points: output ``i``'s
    stream is keyed by ``i``, and the lanes do not mix."""
    gp = _small_gp(8, 15)
    mgp = mogp_tpu_torch.MultiOutputGP(gp.inputs, np.stack([gp.targets, -gp.targets]),
                                       nugget="fit", device="cpu")
    theta = gp.theta.get_data()
    mgp.fit([theta, theta])
    res = tinf.sample_MOGP_MCMC(mgp, n_samples=5, n_warmup=5, n_chains=2, seed=4)
    alone = tinf.sample_GP_MCMC(gp, n_samples=5, n_warmup=5, n_chains=2, seed=4, theta0=theta)
    np.testing.assert_array_equal(res[0].samples, alone.samples)
    assert not np.array_equal(res[1].samples, alone.samples)
