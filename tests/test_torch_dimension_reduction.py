"""The port's gKDR (``uq/dimension_reduction.py``) against ``mogp_tpu``'s, in
float64 on the CPU.

The sign of each eigenvector and the order of tied eigenvalues are
arbitrary, so the projection is compared through its eigenvalues
(relative to the largest, 1e-10) and the projectors ``B[:, :K] B[:, :K]^T``
(1e-9) of the leading ``K``; ``dr(X)`` only through them.  Both are bounded
by the conditioning of ``Kx + N EPS I`` (~1e8 at EPS = 1e-8): the port
builds the Grams through ``kernel_f_predict``'s scaled matmul form and
``mogp_tpu`` in its own, whose last-ulp differences that condition number
magnifies (3.4e-10 in the eigenvalues of ``tests/test_uq.py``'s linear
40 x 3 problem, which the ports below run without the parity check).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402
from scipy.spatial.distance import cdist  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.uq import dimension_reduction as jdr  # noqa: E402
from mogp_tpu_torch.uq import dimension_reduction as tdr  # noqa: E402
from mogp_tpu_torch.uq import gKDR  # noqa: E402

torch.set_num_threads(2)

EVALS_RTOL = 1e-10
PROJ_ATOL = 1e-9


def _problem(seed, N, M, kind):
    np.random.seed(seed)
    X = np.random.rand(N, M)
    if kind == "sin":
        Y = np.sin(2 * np.pi * X[:, 0])
    elif kind == "noisy":
        Y = X[:, 1] + 0.1 * np.random.randn(N)
    else:
        Y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.2 * X[:, 2]
    return X, Y


PROBLEMS = [(30, 80, 5, "sin"), (31, 30, 4, "noisy"), (7, 60, 6, "mixed"),
            (8, 50, 8, "noisy"), (1, 300, 20, "sin")]


def _projector(B, K):
    return B[:, :K] @ B[:, :K].T


def _hold(got, ref, Ks):
    assert got.B.shape == ref.B.shape and got.evals.shape == ref.evals.shape
    assert_allclose(got.evals, ref.evals, rtol=0, atol=EVALS_RTOL * np.abs(ref.evals).max())
    for K in Ks:
        assert_allclose(_projector(got.B, K), _projector(ref.B, K), rtol=0, atol=PROJ_ATOL)


@pytest.mark.parametrize("seed,N,M,kind", PROBLEMS)
def test_gkdr_matches_mogp_tpu(seed, N, M, kind):
    X, Y = _problem(seed, N, M, kind)
    ref = mogp_tpu.gKDR(X, Y, K=2)
    got = gKDR(X, Y, K=2, device="cpu")
    # projectors where the spectrum has a gap
    gaps = np.abs(np.diff(ref.evals)) > 1e-6 * ref.evals[0]
    Ks = [K for K in range(1, M) if gaps[K - 1]][:4]
    assert Ks
    _hold(got, ref, Ks)
    assert got.K == 2
    assert_allclose(got(X) @ got.B[:, :2].T, ref(X) @ ref.B[:, :2].T, rtol=0,
                    atol=PROJ_ATOL * np.abs(X).sum(axis=1).max())


@pytest.mark.parametrize("kw", [dict(X_scale=0.5, Y_scale=5.0), dict(SGX=0.7, SGY=0.2, EPS=1e-6)],
                         ids=["scales", "explicit"])
def test_gkdr_options_match_mogp_tpu(kw):
    X, Y = _problem(30, 80, 5, "sin")
    ref = mogp_tpu.gKDR(X, Y, K=3, **kw)
    got = gKDR(X, Y, K=3, device="cpu", **kw)
    _hold(got, ref, [1])
    assert (got.X_scale, got.Y_scale) == (ref.X_scale, ref.Y_scale)


def test_gkdr_steps_compose_to_the_projection():
    """The step functions that ``chip_smoke.py`` times are the projection."""
    X, Y = _problem(7, 60, 6, "mixed")
    Xt, Yt = torch.tensor(X), torch.tensor(Y[:, None])
    s2x, s2y = 0.3, 0.8
    Kx, Ky = tdr._grams(Xt, Yt, s2x, s2y)
    assert_allclose(Kx.numpy(), tdr.gram_matrix_sqexp(X, s2x), rtol=1e-13)
    assert_allclose(Ky.numpy(), tdr.gram_matrix_sqexp(Y[:, None], s2y), rtol=1e-13)
    L = tdr._factor(Kx, 1e-8)
    B, evals = tdr._eig(tdr._contraction(Xt, Kx, tdr._solves(L, Ky), s2x))
    B0, evals0 = tdr._gkdr_projection(Xt, Yt, s2x, s2y, 1e-8)
    assert torch.equal(B, B0) and torch.equal(evals, evals0)
    assert (evals[:-1] >= evals[1:]).all()


def test_gkdr_failed_factor_gives_nan():
    """With EPS = 0 on duplicated inputs Kx is singular: B and evals are
    all NaN, as in mogp_tpu, and nothing raises."""
    rng = np.random.RandomState(0)
    X = rng.rand(20, 3)
    X = np.vstack([X, X[:5]])
    ref = mogp_tpu.gKDR(X, X[:, 0], K=2, EPS=0.0)
    got = gKDR(X, X[:, 0], K=2, EPS=0.0, device="cpu")
    assert np.isnan(ref.B).all() and np.isnan(ref.evals).all()
    assert got.B.shape == (3, 3) and np.isnan(got.B).all() and np.isnan(got.evals).all()
    assert np.isnan(got(X)).all()


def test_gkdr_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    X, Y = _problem(30, 20, 3, "sin")
    with pytest.raises(RuntimeError, match="cuda"):
        gKDR(X, Y)


# -- the helpers ---------------------------------------------------------------

def test_gram_matrix_helpers_match_mogp_tpu():
    X = np.random.RandomState(2).rand(12, 3)
    k = lambda a, b: np.exp(-np.sum(np.abs(a - b)))  # noqa: E731
    assert_allclose(tdr.gram_matrix(X, k), jdr.gram_matrix(X, k), rtol=1e-15)
    assert_allclose(tdr.gram_matrix(X, k), np.exp(-cdist(X, X, "cityblock")), rtol=1e-14)
    assert_allclose(tdr.gram_matrix_sqexp(X, 0.4), jdr.gram_matrix_sqexp(X, 0.4), rtol=1e-15)
    assert_allclose(np.diag(tdr.gram_matrix_sqexp(X, 0.4)), 1.0)
    assert tdr.median_dist(X) == jdr.median_dist(X)
    assert tdr.median_dist(np.array([[0.0], [1.0], [3.0]])) == 2.0


def test_exports():
    assert mogp_tpu_torch.gKDR is gKDR is mogp_tpu_torch.uq.gKDR
    for name in ("gram_matrix", "gram_matrix_sqexp", "median_dist"):
        assert getattr(mogp_tpu_torch.uq, name) is getattr(tdr, name)


# -- tests/test_uq.py:188-229 ---------------------------------------------------

def test_gkdr_finds_active_dimension():
    """5-D input, response depends on x0 only: the first gKDR direction
    aligns with e0."""
    np.random.seed(30)
    X = np.random.rand(80, 5)
    Y = np.sin(2 * np.pi * X[:, 0])
    dr = gKDR(X, Y, K=1, device="cpu")
    assert abs(dr.B[0, 0]) > 0.9
    assert dr(X).shape == (80, 1)


def test_gkdr_callable_shapes():
    np.random.seed(31)
    X = np.random.rand(30, 4)
    Y = X[:, 1] + 0.1 * np.random.randn(30)
    dr = gKDR(X, Y, K=2, device="cpu")
    assert dr(X).shape == (30, 2)
    assert dr(X[0:1]).shape == (1, 2)


def _linear_model(x, y):
    coeffs = np.linalg.lstsq(np.hstack([x, np.ones((len(x), 1))]), y, rcond=None)[0]
    return lambda xp: np.hstack([xp, np.ones((len(xp), 1))]) @ coeffs


def test_gkdr_tune_parameters():
    np.random.seed(32)
    X = np.random.rand(40, 3)
    Y = 2 * X[:, 0] + 0.01 * np.random.randn(40)
    dr, loss = gKDR.tune_parameters(X, Y, _linear_model, cXs=[1.0], cYs=[1.0], maxK=2,
                                    cross_validation_folds=3, device="cpu")
    assert loss < 0.1
    assert dr.K in (1, 2)


@pytest.mark.parametrize("seed,N,M", [(33, 50, 4), (34, 60, 5)])
def test_tune_parameters_matches_mogp_tpu(seed, N, M):
    """The default grid of scales and the K ladder with its early stop:
    the same (K, X_scale, Y_scale) and the loss within 1e-9."""
    np.random.seed(seed)
    X = np.random.rand(N, M)
    Y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.01 * np.random.randn(N)
    ref, ref_loss = mogp_tpu.gKDR.tune_parameters(X, Y, _linear_model, cross_validation_folds=4)
    got, loss = gKDR.tune_parameters(X, Y, _linear_model, cross_validation_folds=4,
                                     device="cpu")
    assert (got.K, got.X_scale, got.Y_scale) == (ref.K, ref.X_scale, ref.Y_scale)
    assert_allclose(loss, ref_loss, rtol=0, atol=1e-9)


def test_compute_loss_matches_mogp_tpu():
    np.random.seed(35)
    X = np.random.rand(40, 4)
    Y = np.cos(2 * X[:, 1]) + X[:, 0]
    ref = mogp_tpu.gKDR._compute_loss(X, Y, _linear_model, 5, 2, 1.0, 5.0)
    got = gKDR._compute_loss(X, Y, _linear_model, 5, 2, 1.0, 5.0, device="cpu")
    assert_allclose(got, ref, rtol=0, atol=1e-9)
