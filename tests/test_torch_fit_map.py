"""``fit_GP_MAP`` of the port against ``mogp_tpu`` on seeded problems.

Both packages draw the restart starts from numpy's global RNG in the same
order, so a seeded fit can be held against the JAX package output by
output: the same winners, log posteriors and nuggets.  Also the failure
semantics of ``tests/test_fitting.py:81-117`` and the escalation to the
full jitter ladder.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import fitting  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402

torch.set_num_threads(2)

# Log posteriors: float64 on both sides; the optima are well conditioned
# (noisy targets keep the lengthscales short), and the two optimizers take
# the same steps up to summation-order rounding.
LOGPOST_RTOL = 1e-8
# Winners: that rounding, grown over 20 iterations, moves the final
# iterate by ~1e-8; a different winning restart would move it by O(1).
THETA_ATOL = 1e-6

_rng = np.random.RandomState(7)
X = _rng.rand(25, 2) * 2
Y = np.stack([
    np.sin(3 * X[:, 0]) + X[:, 1] ** 2,
    np.cos(2 * X[:, 1]) + X[:, 0],
    X[:, 0] * X[:, 1],
]) + 0.3 * _rng.randn(3, 25)

FIT = dict(n_tries=4, maxiter=20)


def _same_fit(et, ej):
    assert_allclose(et.theta.get_data(), ej.theta.get_data(), rtol=0, atol=THETA_ATOL)
    assert_allclose(et.current_logpost, ej.current_logpost, rtol=LOGPOST_RTOL)
    assert_allclose(et.nugget, ej.nugget, rtol=1e-6, atol=1e-300)


def _dev(pkg):
    """The device argument of the port's constructors (its default is the
    card); the JAX package takes none."""
    return {"device": "cpu"} if pkg is mogp_tpu_torch else {}


def _fit_both(make, seed, **kw):
    out = []
    for pkg in (mogp_tpu, mogp_tpu_torch):
        np.random.seed(seed)
        out.append(pkg.fit_GP_MAP(make(pkg), **kw))
    return out


@pytest.fixture(scope="module")
def mogp_pair():
    return _fit_both(lambda pkg: pkg.MultiOutputGP(X, Y, **_dev(pkg)), 0, **FIT)


@pytest.mark.parametrize("output", range(3))
def test_multi_output_fit_matches_jax(mogp_pair, output):
    mj, mt = mogp_pair
    assert mt.get_indices_not_fit() == mj.get_indices_not_fit() == []
    _same_fit(mt.emulators[output], mj.emulators[output])


def test_multi_output_fit_phases_and_predictions(mogp_pair):
    mj, mt = mogp_pair
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "stage1", "refit"]
    q = np.random.RandomState(3).rand(30, 2) * 2
    rj, rt = mj.predict(q), mt.predict(q)
    assert_allclose(rt.mean, rj.mean, rtol=1e-6, atol=1e-6)
    assert_allclose(rt.unc, rj.unc, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nugget", ["adaptive", "fit"])
def test_single_gp_fit_with_theta0_matches_jax(nugget):
    theta0 = np.zeros(3 + int(nugget == "fit"))
    gj, gt = _fit_both(lambda pkg: pkg.GaussianProcess(X, Y[0], nugget=nugget, **_dev(pkg)), 1,
                       theta0=theta0, **FIT)
    _same_fit(gt, gj)


def test_chunking_changes_no_result(monkeypatch):
    np.random.seed(5)
    whole = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu"), **FIT)
    assert fitting._max_lanes(whole.emulators[0]) >= 12
    monkeypatch.setattr(fitting, "_CHUNK_BYTES", 1)  # one output per chunk
    np.random.seed(5)
    chunked = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu"), **FIT)
    for a, b in zip(whole.emulators, chunked.emulators):
        assert np.array_equal(a.theta.get_data(), b.theta.get_data())
        assert a.current_logpost == b.current_logpost


@pytest.mark.parametrize("kw", [{}, {"nugget": "fit"}, {"mean": "x[0]+x[1]"}],
                         ids=["zero_mean", "nugget_fit", "linear_mean"])
def test_single_gp_and_one_output_mogp_share_the_schedule(kw):
    """A single GP runs the schedule as a group of one: from the same seed
    it reaches the one-output MultiOutputGP's fit bit for bit."""
    rng = np.random.RandomState(11)
    x = rng.rand(30, 3)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * rng.randn(30)
    fit = dict(n_tries=6, maxiter=30)
    np.random.seed(6)
    gp = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.GaussianProcess(x, y, device="cpu", **kw), **fit)
    np.random.seed(6)
    mgp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.MultiOutputGP(x, y[None], device="cpu", **kw), **fit)
    em = mgp.emulators[0]
    assert np.array_equal(gp.theta.get_data(), em.theta.get_data())
    assert gp.current_logpost == em.current_logpost


@pytest.fixture
def single_rung_fails(monkeypatch):
    """Every point fails on the one-rung trajectory ladder, as near-
    duplicate inputs can make it in float32."""
    real = tchol.jit_cholesky

    def jit_cholesky(A, *args, sparse_ladder=False, **kw):
        F, jitter = real(A, *args, sparse_ladder=sparse_ladder, **kw)
        if sparse_ladder == "single":
            return tchol.ChoFactor(F.L * torch.nan), jitter * torch.nan
        return F, jitter

    monkeypatch.setattr(tchol, "jit_cholesky", jit_cholesky)


def test_escalation_refits_failed_outputs_with_the_full_ladder(single_rung_fails):
    """Outputs with no finite restart run again from their starts, without
    the race, on the full ladder: the JAX package's strict schedule."""
    np.random.seed(2)
    mj = mogp_tpu.fit_GP_MAP(mogp_tpu.MultiOutputGP(X, Y[:2]), race=False, opt_ladder="full",
                             **FIT)
    np.random.seed(2)
    mt = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(X, Y[:2], device="cpu"), **FIT)
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "stage1", "rescue", "refit"]
    for et, ej in zip(mt.emulators, mj.emulators):
        _same_fit(et, ej)


def test_single_gp_escalation_reruns_the_schedule(single_rung_fails):
    gj, gt = _fit_both(lambda pkg: pkg.GaussianProcess(X, Y[1], **_dev(pkg)), 4,
                       opt_ladder="full", **FIT)
    np.random.seed(4)
    ge = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.GaussianProcess(X, Y[1], device="cpu"), **FIT)
    _same_fit(ge, gj)
    assert np.array_equal(ge.theta.get_data(), gt.theta.get_data())


# ---------------------------------------------------------------------------
# failure semantics (tests/test_fitting.py:81-117), on the port
# ---------------------------------------------------------------------------

def test_total_failure_raises():
    gp = mogp_tpu_torch.GaussianProcess(X, np.full(25, np.nan), device="cpu")
    with pytest.raises(RuntimeError):
        mogp_tpu_torch.fit_GP_MAP(gp, n_tries=2, maxiter=5)


def test_mogp_failure_skipping_and_nan_predictions(capsys):
    ys = np.stack([Y[0], np.full(25, np.nan)])
    mgp = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(X, ys, device="cpu"), n_tries=2,
                                    maxiter=5, skip_failures=True)
    assert mgp.get_indices_not_fit() == [1]
    assert mgp.emulators[1].theta.get_data() is None
    assert "Fitting failed for emulators" in capsys.readouterr().out
    res = mgp.predict(X[:3], allow_not_fit=True)
    assert np.isfinite(res.mean[0]).all() and np.isnan(res.mean[1]).all()
    with pytest.raises(ValueError):
        mgp.predict(X[:3])
    with pytest.raises(RuntimeError):
        mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(X, ys, device="cpu"), n_tries=2,
                                  maxiter=5,
                                  skip_failures=False, refit=True)


def test_refit_semantics_and_arguments():
    mgp = mogp_tpu_torch.MultiOutputGP(X, Y[:2], device="cpu")
    mgp = mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=2, maxiter=5)
    thetas = [em.theta.get_data().copy() for em in mgp.emulators]
    mgp = mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=2, maxiter=5)  # nothing left to fit
    for em, t in zip(mgp.emulators, thetas):
        assert np.array_equal(em.theta.get_data(), t)
    with pytest.raises(TypeError):
        mogp_tpu_torch.fit_GP_MAP(1.5)
    with pytest.raises(TypeError):
        mogp_tpu_torch.fit_GP_MAP()
    with pytest.raises(AssertionError):
        mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.GaussianProcess(X, Y[0], device="cpu"), n_tries=1,
                                  theta0=np.zeros(99))
    gp = mogp_tpu_torch.fit_GP_MAP(X, Y[0], n_tries=2, maxiter=5, device="cpu")
    assert isinstance(gp, mogp_tpu_torch.GaussianProcess)
    mgp = mogp_tpu_torch.fit_GP_MAP(X, Y[:2], n_tries=2, maxiter=5, nugget="fit", device="cpu")
    assert isinstance(mgp, mogp_tpu_torch.MultiOutputGP) and mgp.get_indices_not_fit() == []
    with pytest.warns(UserWarning):
        mogp_tpu_torch.fit_GP_MAP(X, Y[0], n_tries=1, maxiter=5, not_an_option=1, device="cpu")
