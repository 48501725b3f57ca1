"""The port's NUTS (``mogp_tpu_torch/ops/hmc.py``) against ``mogp_tpu``.

The deterministic pieces -- leapfrog, kinetic energy, the U-turn
criterion, dual averaging, Welford's variance and the two diagnostics --
take the same float64 inputs in both packages and must agree to rounding
(``rtol`` 1e-12: the same formulas, summed in other orders).  The random
streams differ (Philox counters here, ``jax.random`` there), so the
sampler itself is held to the statistical oracles of
``tests/test_inference.py``, with the same seeds and assertions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from mogp_tpu.models import inference as jinf  # noqa: E402
from mogp_tpu.ops import hmc as jhmc  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402
from mogp_tpu_torch.ops import hmc  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _gaussian(prec):
    """Batched ``0.5 q^T prec q`` for the port and one-chain for JAX."""
    tp, jp = _t(prec), jnp.asarray(prec)
    return (lambda q: 0.5 * torch.sum((q @ tp) * q, dim=-1),
            lambda q: 0.5 * q @ jp @ q)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = hmc.philox4x32([torch.tensor(c, dtype=torch.int64) for c in ctr], key)
        assert [int(w) for w in got] == list(want)


def test_stream_is_per_lane_and_uniform():
    """A lane's numbers depend on (seed, chain, output, transition) only,
    and are uniform on (0, 1]."""
    s8 = hmc.Stream(5, torch.arange(8), torch.full((8,), 3))
    s1 = hmc.Stream(5, torch.tensor([6]), torch.tensor([3]))
    u8, u1 = s8.uniforms(11, 301), s1.uniforms(11, 301)
    assert torch.equal(u8[6:7], u1)
    assert not torch.equal(s8.uniforms(12, 301), u8)
    u = hmc.Stream(0, torch.arange(64), torch.zeros(64)).uniforms(0, 1000).numpy().ravel()
    assert 0.0 < u.min() and u.max() <= 1.0
    # 64000 uniforms: mean 1/2 and variance 1/12 within 5 standard errors
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / u.size)
    assert abs(u.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / u.size)
    z = hmc._normals(hmc.Stream(1, torch.arange(64), torch.zeros(64)).uniforms(0, 1000))
    z = z.numpy().ravel()
    assert abs(z.mean()) < 5 / np.sqrt(z.size) and abs(z.var() - 1) < 5 * np.sqrt(2 / z.size)


def test_leapfrog_and_kinetic_match_jax():
    rng = np.random.RandomState(0)
    L, P = 5, 3
    A = rng.randn(P, P)
    prec = A @ A.T + P * np.eye(P)
    tpot, jpot = _gaussian(prec)
    q, p, inv_mass = rng.randn(L, P), rng.randn(L, P), rng.uniform(0.5, 2.0, (L, P))
    step = rng.uniform(0.05, 0.3, L) * np.where(rng.rand(L) < 0.5, 1.0, -1.0)
    grad = q @ prec
    got = hmc._leapfrog(hmc.potential_and_grad(tpot), _t(inv_mass), _t(step)[:, None], _t(q),
                        _t(p), _t(grad))
    jpg = jax.value_and_grad(jpot)
    for lane in range(L):
        ref = jhmc._leapfrog(jpg, inv_mass[lane], step[lane], q[lane], p[lane], grad[lane])
        for g, r in zip(got, ref):
            assert_allclose(g[lane].numpy(), np.asarray(r), rtol=RTOL, atol=1e-13)
        assert_allclose(hmc._kinetic(_t(inv_mass), _t(p))[lane].numpy(),
                        float(jhmc._kinetic(inv_mass[lane], p[lane])), rtol=RTOL)


def test_is_turning_matches_jax():
    rng = np.random.RandomState(1)
    L, P = 400, 4
    args = [rng.uniform(0.5, 2.0, (L, P)), rng.randn(L, P), rng.randn(L, P), rng.randn(L, P)]
    got = hmc._is_turning(*map(_t, args)).numpy()
    ref = np.array([bool(jhmc._is_turning(*(a[i] for a in args))) for i in range(L)])
    assert 0 < got.sum() < L
    np.testing.assert_array_equal(got, ref)


def test_dual_averaging_matches_jax():
    rng = np.random.RandomState(2)
    accepts = rng.uniform(0.0, 1.0, 30)
    for target in (0.6, 0.8):
        t = hmc._da_init(_t([0.1]))
        j = jhmc._da_init(jnp.asarray(0.1))
        for a in accepts:
            t = hmc._da_update(t, _t([a]), target=target)
            j = jhmc._da_update(j, a, target=target)
        for g, r in zip(t, j):
            assert_allclose(g.numpy()[0], float(r), rtol=RTOL)


@pytest.mark.parametrize("regularize", [True, False])
def test_welford_variance_matches_jax(regularize):
    rng = np.random.RandomState(3)
    xs = rng.randn(40, 2, 3) * np.array([1.0, 5.0, 0.1])
    t = hmc._welford_init(_t(xs[0]))
    js = [jhmc._welford_init(3, jnp.float64) for _ in range(2)]
    for x in xs:
        t = hmc._welford_update(t, _t(x))
        js = [jhmc._welford_update(j, x[i]) for i, j in enumerate(js)]
    got = hmc._welford_var(t, regularize=regularize).numpy()
    for i, j in enumerate(js):
        assert_allclose(got[i], np.asarray(jhmc._welford_var(j, regularize=regularize)),
                        rtol=RTOL)


@pytest.mark.parametrize("shape", [(4, 200, 3), (1, 101, 2), (8, 64, 1)])
def test_diagnostics_match_jax(shape):
    rng = np.random.RandomState(4)
    # AR(1) chains with a chain offset: both diagnostics away from their limits
    x = rng.randn(*shape)
    for i in range(1, shape[1]):
        x[:, i] = 0.7 * x[:, i - 1] + x[:, i]
    x += 0.3 * rng.randn(shape[0], 1, shape[2])
    assert_allclose(tinf.potential_scale_reduction(x).numpy(),
                    np.asarray(jinf.potential_scale_reduction(jnp.asarray(x))), rtol=RTOL)
    assert_allclose(tinf.effective_sample_size(x).numpy(),
                    np.asarray(jinf.effective_sample_size(jnp.asarray(x))), rtol=RTOL)


# -- statistical ports of tests/test_inference.py -----------------------------

def test_nuts_gaussian_moments():
    cov = np.array([[2.0, 1.2], [1.2, 1.5]])
    tpot, _ = _gaussian(np.linalg.inv(cov))
    q0 = _t(np.random.RandomState(1).randn(4, 2))
    samples, infos = hmc.sample_nuts(hmc.potential_and_grad(tpot), q0, 0, n_warmup=400,
                                     n_samples=600)
    s = samples.numpy().reshape(-1, 2)
    assert_allclose(s.mean(axis=0), np.zeros(2), atol=0.15)
    assert_allclose(np.cov(s.T), cov, atol=0.3)
    assert float(infos.accept_prob.mean()) > 0.6
    assert int(infos.diverging.sum()) == 0
    assert np.all(tinf.potential_scale_reduction(samples).numpy() < 1.05)
    assert np.all(tinf.effective_sample_size(samples).numpy() > 100)


def test_ess_iid_close_to_n():
    """ESS of iid draws is close to the total sample count."""
    ess = tinf.effective_sample_size(np.random.RandomState(2).randn(4, 500, 2)).numpy()
    assert np.all(ess > 1000)  # 2000 total, allow wide tolerance


def test_rhat_detects_nonconvergence():
    chains = np.random.RandomState(0).randn(4, 200, 1)
    chains[0] += 10.0  # one chain stuck elsewhere
    assert tinf.potential_scale_reduction(chains).numpy()[0] > 1.5


def test_nuts_max_depth_one():
    """max_depth=1 degenerates gracefully (two-leaf trees)."""
    pg = hmc.potential_and_grad(lambda q: 0.5 * torch.sum(q**2, dim=-1))
    samples, infos = hmc.sample_nuts(pg, torch.zeros(1, 2, dtype=torch.float64), 3,
                                     n_warmup=100, n_samples=200, max_depth=1)
    s = samples.numpy()
    assert np.all(np.isfinite(s))
    assert abs(s.mean()) < 0.3
    assert np.all(infos.n_leapfrog.numpy() <= 2)


def test_nuts_respects_target_accept():
    pg = hmc.potential_and_grad(lambda q: 0.5 * torch.sum(q**2, dim=-1))
    # the multinomial-NUTS acceptance statistic runs biased above the
    # dual-averaging target on easy targets, so low targets are only
    # checked loosely (as in tests/test_inference.py)
    for target, tol in ((0.6, 0.25), (0.9, 0.1)):
        _, infos = hmc.sample_nuts(pg, torch.zeros(1, 3, dtype=torch.float64), 4, n_warmup=400,
                                   n_samples=200, target_accept=target)
        assert abs(float(infos.accept_prob.mean()) - target) < tol


def test_non_finite_potential_is_a_divergence():
    """A lane whose potential turns NaN (a failed factorization) diverges
    and keeps its state; the other lanes are not touched."""
    def pot(q):
        u = 0.5 * torch.sum(q**2, dim=-1)
        return torch.where(q[:, 0] > 4.0, torch.nan, u)

    pg = hmc.potential_and_grad(pot)
    q = _t([[3.9, 0.0], [-1.0, 0.0]])
    u, g = pg(q)
    draws = hmc._transition_draws(hmc.Stream(0, torch.arange(2), torch.zeros(2)), 0, 2, 8)
    # forward in every doubling, lane 0 straight into the NaN region
    draws = draws._replace(momentum=_t([[4.0, 0.0], [0.1, 0.2]]),
                           direction=torch.zeros_like(draws.direction))
    q1, u1, _, info = hmc.nuts_step(pg, q, u, g, _t([0.2, 0.2]), torch.ones(2, 2,
                                    dtype=torch.float64), draws)
    assert bool(info.diverging[0]) and not bool(info.diverging[1])
    assert torch.isfinite(u1).all() and bool((q1[0, 0] <= 4.0))
