"""The port's inference entry points (``models/inference.py``) against
``mogp_tpu``.

Where the two packages can be given the same numbers, they must agree:
``predict_MCMC`` on one samples array (``rtol`` 1e-10: a float64 ``gp_fit``
and prediction per sample, well-conditioned K), and VI's negative ELBO,
its gradient and 20 Adam steps at the same draws (``rtol`` 1e-9, the
``gp_nlp`` parity of ``tests/test_torch_fit.py``).  The samplers' random
streams differ, so NUTS and VI are held to the statistical assertions of
``tests/test_inference.py``, with its seeds.  Within the port a chain's
samples do not depend on the other lanes of its batch, and every
``mesh=`` that is not a ``parallel.DeviceMesh`` raises ``TypeError``
(``tests/test_torch_parallel_*.py`` run the mesh paths).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.models import fitting as jfit  # noqa: E402
from mogp_tpu.models import gp as jgp  # noqa: E402
from mogp_tpu.models import inference as jinf  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402
from mogp_tpu_torch.models.gp import take_lanes  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fit_gp():
    np.random.seed(3)
    x = np.random.rand(25, 2) * 2
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * np.random.randn(25)
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cpu")
    return mogp_tpu_torch.fit_GP_MAP(gp, n_tries=4)


def _twin(gp):
    """The same emulator in ``mogp_tpu``, fit at the same hyperparameters."""
    jg = mogp_tpu.GaussianProcess(gp.inputs, gp.targets, nugget=gp.nugget_type)
    jg.fit(gp.theta.get_data())
    return jg


# -- mesh= -------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["fit_GP_MAP", "sample_GP_MCMC", "sample_MOGP_MCMC",
                                   "smc_history_match"])
def test_mesh_is_refused(entry, fit_gp):
    """A ``mesh`` that is not a ``parallel.DeviceMesh`` raises ``TypeError``
    instead of running on one device."""
    mgp = mogp_tpu_torch.MultiOutputGP(fit_gp.inputs, np.stack([fit_gp.targets] * 2),
                                       nugget="fit", device="cpu")
    calls = {
        "fit_GP_MAP": lambda: mogp_tpu_torch.fit_GP_MAP(fit_gp, n_tries=1, mesh=object()),
        "sample_GP_MCMC": lambda: mogp_tpu_torch.sample_GP_MCMC(fit_gp, 2, 2, mesh=object()),
        "sample_MOGP_MCMC": lambda: mogp_tpu_torch.sample_MOGP_MCMC(mgp, 2, 2, mesh=object()),
        "smc_history_match": lambda: mogp_tpu_torch.smc_history_match(
            fit_gp, 0.0, [[0, 2], [0, 2]], mesh=object()),
    }
    with pytest.raises(TypeError, match="DeviceMesh"):
        calls[entry]()


# -- parity at the same numbers ----------------------------------------------

def test_predict_mcmc_matches_jax(fit_gp):
    theta = fit_gp.theta.get_data()
    samples = theta + 0.3 * np.random.RandomState(0).randn(2, 20, theta.size)
    xt = np.random.RandomState(5).rand(7, 2) * 2
    for thin in (1, 3):
        got = tinf.predict_MCMC(fit_gp, samples, xt, thin=thin)
        ref = jinf.predict_MCMC(_twin(fit_gp), samples, xt, thin=thin)
        for g, r in zip(got, ref):
            assert_allclose(g, r, rtol=1e-10)


def test_predict_mcmc_drops_non_finite_samples(fit_gp):
    theta = fit_gp.theta.get_data()
    samples = np.stack([theta, theta + 0.1, theta + np.inf])
    xt = np.random.RandomState(6).rand(4, 2)
    got = tinf.predict_MCMC(fit_gp, samples, xt)
    ref = tinf.predict_MCMC(fit_gp, samples[:2], xt)
    for g, r in zip(got, ref):
        assert_allclose(g, r, rtol=1e-14)


def _jax_neg_elbo(jg, n_mc):
    """``mogp_tpu``'s ADVI objective (``models/inference.py:666-676``) at
    given draws ``eps``."""
    P = jg.n_params

    def neg_elbo(params, eps):
        mu, log_std = params
        zs = mu + jnp.exp(log_std) * eps
        nlps = jax.vmap(lambda z: jgp.gp_nlp(z, jg._data, jg.kernel, jg.nugget_type,
                                             sparse_ladder=jfit._OPT_LADDER))(zs)
        nlps = jnp.where(jnp.isfinite(nlps), nlps, 1e10)
        entropy = jnp.sum(log_std) + 0.5 * P * (1.0 + jnp.log(2.0 * jnp.pi))
        return jnp.mean(nlps) - entropy

    return neg_elbo


def test_neg_elbo_and_adam_match_jax(fit_gp):
    n_mc, n_steps, lr = 8, 20, 0.05
    P = fit_gp.n_params
    eps = np.random.RandomState(7).randn(n_steps, n_mc, P)
    mu0 = fit_gp.theta.get_data() + 0.2
    log_std0 = np.full(P, -2.0)
    jfn = jax.jit(jax.value_and_grad(_jax_neg_elbo(_twin(fit_gp), n_mc)))
    data = take_lanes(fit_gp._data, torch.zeros(n_mc, dtype=torch.int64))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731

    loss, g_mu, g_ls = tinf._neg_elbo(t(mu0), t(log_std0), t(eps[0]),
                                      tinf.gp_potential(data, fit_gp.kernel, fit_gp.nugget_type))
    jl, (jg_mu, jg_ls) = jfn((jnp.asarray(mu0), jnp.asarray(log_std0)), eps[0])
    assert_allclose(loss.item(), float(jl), rtol=1e-9)
    assert_allclose(g_mu.numpy(), np.asarray(jg_mu), rtol=1e-9, atol=1e-10)
    assert_allclose(g_ls.numpy(), np.asarray(jg_ls), rtol=1e-9, atol=1e-10)

    mu, log_std, trace = tinf._vi_run(t(mu0), t(log_std0), lambda k: t(eps[k]), n_steps, lr, data,
                                      fit_gp.kernel, fit_gp.nugget_type)
    opt = optax.adam(lr)
    params = (jnp.asarray(mu0), jnp.asarray(log_std0))
    state = opt.init(params)
    jtrace = []
    for k in range(n_steps):
        loss, grads = jfn(params, eps[k])
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        jtrace.append(-float(loss))
    assert_allclose(mu.numpy(), np.asarray(params[0]), rtol=1e-9)
    assert_allclose(log_std.numpy(), np.asarray(params[1]), rtol=1e-9)
    assert_allclose(trace.numpy(), jtrace, rtol=1e-9)


def test_neg_elbo_penalizes_failed_draws(fit_gp):
    """A draw whose factorization fails counts 1e10 and adds no gradient;
    the other draws' gradients stay finite."""
    P = fit_gp.n_params
    lanes = [take_lanes(fit_gp._data, torch.zeros(k, dtype=torch.int64)) for k in (2, 1)]
    eps = torch.zeros(2, P, dtype=torch.float64)
    eps[1, -2] = 1e4   # sigma^2 = exp(1e4 + ...) = inf: no factor in lane 1
    mu = torch.as_tensor(fit_gp.theta.get_data() + 0.3, dtype=torch.float64)
    zero = torch.zeros(P, dtype=torch.float64)
    pot = [tinf.gp_potential(d, fit_gp.kernel, fit_gp.nugget_type) for d in lanes]
    loss, g_mu, g_ls = tinf._neg_elbo(mu, zero, eps, pot[0])
    one, g1, _ = tinf._neg_elbo(mu, zero, eps[:1], pot[1])
    entropy = 0.5 * P * (1.0 + np.log(2.0 * np.pi))
    assert_allclose(loss.item(), (one.item() + entropy + 1e10) / 2 - entropy, rtol=1e-12)
    assert_allclose(g_mu.numpy(), g1.numpy() / 2, rtol=1e-12)
    assert torch.isfinite(g_ls).all()


# -- the chains ---------------------------------------------------------------

def test_a_chain_does_not_depend_on_its_batch(fit_gp):
    """Chain 0 alone and inside a batch of 8: the same samples, bit for bit
    (its start and draws are functions of (seed, chain) only)."""
    kw = dict(n_samples=6, n_warmup=6, seed=2, theta0=fit_gp.theta.get_data())
    one = tinf.sample_GP_MCMC(fit_gp, n_chains=1, **kw)
    eight = tinf.sample_GP_MCMC(fit_gp, n_chains=8, **kw)
    np.testing.assert_array_equal(eight.samples[:1], one.samples)
    np.testing.assert_array_equal(eight.accept_prob[:1], one.accept_prob)
    assert not np.array_equal(eight.samples[1], eight.samples[0])


def test_chains_start_from_the_priors(fit_gp):
    res = tinf.sample_GP_MCMC(fit_gp, n_samples=4, n_warmup=4, n_chains=3, seed=0)
    assert res.samples.shape == (3, 4, fit_gp.n_params)
    assert np.all(np.isfinite(res.samples))


def test_gp_vi(fit_gp):
    vi = tinf.fit_GP_VI(fit_gp, n_steps=300, theta0=fit_gp.theta.get_data())
    assert vi.mean.shape == (fit_gp.n_params,)
    assert vi.elbo_trace[-1] > vi.elbo_trace[0]
    # VI mean should also be near the MAP for this well-identified posterior
    assert np.all(np.abs(vi.mean - fit_gp.theta.get_data()) < 2.0)


def test_vi_posterior_matches_quadrature_oracle():
    """Mean-field VI against the quadrature oracle of
    ``tests/test_inference.py`` (``test_torch_inference_oracle.py``)."""
    from test_torch_inference_oracle import quadrature_oracle

    gp, mean_q, var_q = quadrature_oracle()
    vi = tinf.fit_GP_VI(gp, n_steps=1000, theta0=gp.theta.get_data(), seed=1)
    vi_var = np.exp(2.0 * vi.log_std)
    # ELBO converged upward.  Each entry is an 8-draw estimate whose spread
    # (~0.3 nats here) exceeds the rise (~0.2), so the first and last 50
    # steps' means are compared, not the two end points
    assert vi.elbo_trace[-50:].mean() > vi.elbo_trace[:50].mean()
    # variational mean within half a posterior standard deviation
    assert np.all(np.abs(vi.mean - mean_q) < 0.5 * np.sqrt(var_q))
    # mean-field bias direction: underestimates the marginal variances of a
    # correlated posterior (a little slack above), without collapsing
    assert np.all(vi_var <= 1.05 * var_q)
    assert np.all(vi_var >= 0.25 * var_q)


def test_auto_segment_policy():
    from mogp_tpu_torch.models.inference import _NUTS_SEG_BUDGET, _auto_segment

    assert _NUTS_SEG_BUDGET == jinf._NUTS_SEG_BUDGET
    # small runs stay in one segment
    assert _auto_segment(8, 400) is None  # the known-good point
    assert _auto_segment(4, 200) is None
    # 64 chains x 400 iterations (the observed worker-fault config) split
    seg = _auto_segment(64, 400)
    assert seg is not None and seg * 64 <= _NUTS_SEG_BUDGET + 64 * seg % 64
    assert _auto_segment(64, 400) * (-(-400 // _auto_segment(64, 400))) >= 400
    for lanes, iters in ((1, 1), (64, 400), (256, 100), (7, 1000), (3200, 3)):
        assert _auto_segment(lanes, iters) == jinf._auto_segment(lanes, iters)
