"""``nugget="pivot"`` in the port against ``mogp_tpu``: the pivoted
Cholesky (full rank, rank-deficient, batched lanes of mixed rank), the
log posterior and its gradient, fit / MAP fit / predict on duplicated
inputs, checkpoints, and the rule that a pivoted lane never reaches the
fused prediction.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.ops.cholesky import pivoted_cholesky as j_pivoted  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402
from mogp_tpu_torch.ops.cholesky import pivoted_cholesky  # noqa: E402
from mogp_tpu_torch.utils.checkpoint import load_gp, load_mogp, save_gp, save_mogp  # noqa: E402

torch.set_num_threads(2)

# float64 on both sides, the same greedy pivoting; LAPACK and XLA round in
# other orders, which moves factors and solves by ~1e-13 of their scale.
FACTOR_ATOL = 1e-10
# the log posterior and its gradient at a rank-deficient K: the solves run
# on the leading block (condition ~1e4 here), so ~1e-12 relative
LOGPOST_RTOL = 1e-10
GRAD_ATOL = 1e-8
# predictions at the duplicated-input problem (as tests/test_gp.py:179-187)
PRED_ATOL = 1e-10


def _psd(n, r, rng):
    X = rng.randn(n, r)
    return X @ X.T


def _check_factor(ft, A):
    """One lane of the port's factor against mogp_tpu's on ``A``.

    Past the rank the remaining Schur diagonal is rounding noise, so the
    order of the deficient positions is too: P must agree on the first
    ``rank`` positions and as a set after them, and L row by row in the
    original order."""
    fj = j_pivoted(jnp.asarray(A))
    r = int(fj.rank)
    assert int(ft.rank) == r
    Pj, Pt = np.asarray(fj.P), ft.P.numpy()
    assert_array_equal(Pt[:r], Pj[:r])
    assert sorted(Pt[r:]) == sorted(Pj[r:])
    Lj, Lt = np.asarray(fj.L), ft.L.numpy()
    scale = np.abs(Lj).max()
    assert_allclose(Lt[np.argsort(Pt)][:, :r], Lj[np.argsort(Pj)][:, :r], atol=FACTOR_ATOL * scale)
    assert_allclose(np.diag(Lt), np.diag(Lj), rtol=1e-10)
    assert_array_equal(np.triu(Lt, 1), 0.0)
    assert_array_equal(Lt[:, r:] - np.diag(np.diag(Lt))[:, r:], 0.0)
    assert_allclose(float(ft.logdet()), float(fj.logdet()), rtol=1e-12)

    rng = np.random.RandomState(5)
    b, B = rng.randn(A.shape[0]), rng.randn(A.shape[0], 3)
    for rhs in (b, B):
        xj = np.asarray(fj.solve(jnp.asarray(rhs)))
        xt = ft.solve(torch.tensor(rhs)).numpy()
        assert_allclose(xt, xj, atol=FACTOR_ATOL * max(1.0, np.abs(xj).max()))
        wj = np.asarray(fj.solve_L(jnp.asarray(rhs)))
        wt = ft.solve_L(torch.tensor(rhs)).numpy()
        assert_allclose(wt[:r], wj[:r], atol=FACTOR_ATOL * max(1.0, np.abs(wj).max()))
        assert_array_equal(wt[r:], 0.0)
        assert_allclose(ft.solve_from_half(torch.tensor(wt)).numpy(), xt, atol=1e-12)


@pytest.mark.parametrize("n,r", [(9, 9), (12, 5), (30, 30), (30, 11), (6, 0)])
def test_pivoted_cholesky_matches_mogp_tpu(n, r):
    rng = np.random.RandomState(n + r)
    A = _psd(n, r, rng) if r else np.zeros((n, n))  # r = 0: no pivot above 0
    ft = pivoted_cholesky(torch.tensor(A))
    if r:
        _check_factor(ft, A)
    else:
        assert int(ft.rank) == 0
        fj = j_pivoted(jnp.asarray(A))
        assert_allclose(np.diag(ft.L.numpy()), np.diag(np.asarray(fj.L)), rtol=1e-12)


def test_pivoted_cholesky_batched_lanes_of_mixed_rank():
    """Lanes of rank 12, 4 and 9 (and a duplicated-row kernel matrix) in one
    call, each equal to its own unbatched factor in mogp_tpu."""
    rng = np.random.RandomState(3)
    x = rng.rand(11, 2)
    x = np.vstack([x, x[2]])
    K = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1) / 0.3)
    As = np.stack([_psd(12, 12, rng), _psd(12, 4, rng), _psd(12, 9, rng), K])
    ft = pivoted_cholesky(torch.tensor(As))
    assert ft.L.shape == (4, 12, 12) and ft.P.shape == (4, 12) and ft.rank.shape == (4,)
    assert ft.rank.tolist() == [12, 4, 9, 11]
    for i in range(4):
        _check_factor(mogp_tpu_torch.ops.PivotedChoFactor(ft.L[i], ft.P[i], ft.rank[i]), As[i])


def _duplicated(seed=0, n=20, D=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, D)
    Y = np.sin(X @ np.arange(1.0, D + 1)) + 0.05 * rng.randn(n)
    Xd = np.vstack([X, X[-1], X[3]])
    return Xd, np.concatenate([Y, Y[-1:], Y[3:4]]), rng.rand(7, D)


@pytest.mark.parametrize("mean", [None, "x[0]"])
def test_gp_nlp_value_and_gradient(mean):
    """The log posterior and its autograd gradient at a rank-deficient K
    (two duplicated inputs), against jax.grad of mogp_tpu's fori_loop."""
    X, Y, _ = _duplicated()
    gj = mogp_tpu.GaussianProcess(X, Y, mean=mean, nugget="pivot")
    gt = mogp_tpu_torch.GaussianProcess(X, Y, mean=mean, nugget="pivot", device="cpu")
    for th in (np.array([0.3, -0.2, 0.5, 0.1]), np.array([-1.0, 0.4, 1.2, -0.3])):
        assert_allclose(gt.logposterior(th), gj.logposterior(th), rtol=LOGPOST_RTOL)
        assert_allclose(gt.logpost_deriv(th), gj.logpost_deriv(th), atol=GRAD_ATOL, rtol=1e-9)
        assert int(gt.Kinv.rank) == int(gj.Kinv.rank) == 20
    # the lanes form (the MAP objective) matches the one-lane form
    raw = torch.tensor(np.array([[0.3, -0.2, 0.5, 0.1], [-1.0, 0.4, 1.2, -0.3]]))
    lanes = tgp.take_lanes(gt._data, torch.zeros(2, dtype=torch.int64))
    nlp = tgp.gp_nlp(raw, lanes, gt.kernel, "pivot")
    assert_allclose(nlp.numpy(), [gj.logposterior(r) for r in raw.numpy()], rtol=LOGPOST_RTOL)


def test_gp_nlp_hessian():
    X, Y, _ = _duplicated(seed=1)
    gj = mogp_tpu.GaussianProcess(X, Y, nugget="pivot")
    gt = mogp_tpu_torch.GaussianProcess(X, Y, nugget="pivot", device="cpu")
    th = np.array([0.2, 0.1, -0.4, 0.3])
    hj = gj.logpost_hessian(th)
    assert_allclose(gt.logpost_hessian(th), hj, atol=1e-7 * np.abs(hj).max())


@pytest.mark.parametrize("mean", [None, "x[0] + x[1]"])
def test_fit_predict_on_duplicated_inputs(mean):
    """tests/test_gp.py:179-187 in both packages: the fit succeeds on a
    singular K, and mean, variance and full covariance agree."""
    X, Y, q = _duplicated(seed=2)
    gj = mogp_tpu.GaussianProcess(X, Y, mean=mean, nugget="pivot")
    gt = mogp_tpu_torch.GaussianProcess(X, Y, mean=mean, nugget="pivot", device="cpu")
    th = np.zeros(gj.n_params)
    gj.fit(th)
    gt.fit(th)
    assert np.isfinite(gt.current_logpost)
    assert_allclose(gt.current_logpost, gj.current_logpost, rtol=LOGPOST_RTOL)
    assert_allclose(gt.theta.mean, gj.theta.mean, atol=PRED_ATOL * 10)
    for full_cov in (False, True):
        for include_nugget in (True, False):
            rj = gj.predict(q, full_cov=full_cov, include_nugget=include_nugget)
            rt = gt.predict(q, full_cov=full_cov, include_nugget=include_nugget)
            assert_allclose(rt.mean, rj.mean, atol=PRED_ATOL)
            assert_allclose(rt.unc, rj.unc, atol=PRED_ATOL)
    assert np.all(np.isfinite(gt.predict(X[:4]).unc))


def test_map_fit_and_mogp_match_mogp_tpu():
    """fit_GP_MAP of a pivot GP and of a pivot MultiOutputGP (its lanes and
    the refit), seeded alike, and the MultiOutputGP's predictions.

    At full rank the pivoted log posterior is the plain one in another
    order, and the two optimizers take the same steps.  Below full rank
    the reference's synthetic tail diagonal makes it depend on the pivot
    order, and so on which of K's equal diagonal entries rounding makes
    the largest: there the packages' seeded fits can part (ROADMAP C),
    and the port's is held to its own objective."""
    rng = np.random.RandomState(3)
    X = rng.rand(22, 3)
    Y = np.stack([np.sin(X @ [1.0, 2.0, 3.0]), np.cos(3 * X[:, 0]) + X[:, 2]])
    Y = Y + 0.05 * rng.randn(2, 22)
    np.random.seed(12)
    mj = mogp_tpu.fit_GP_MAP(mogp_tpu.MultiOutputGP(X, Y, nugget="pivot"), n_tries=3, maxiter=20)
    np.random.seed(12)
    mt = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.MultiOutputGP(X, Y, nugget="pivot", device="cpu"), n_tries=3, maxiter=20)
    for ej, et in zip(mj.emulators, mt.emulators):
        assert_allclose(et.current_logpost, ej.current_logpost, rtol=1e-8)
        assert_allclose(et.theta.get_data(), ej.theta.get_data(), atol=1e-6)
        assert int(et.Kinv.rank) == 22
    # a single GP draws the first output's starts from the same seed
    np.random.seed(12)
    gt = mogp_tpu_torch.fit_GP_MAP(X, Y[0], nugget="pivot", n_tries=3, maxiter=20, device="cpu")
    ej = mj.emulators[0]
    assert_allclose(gt.current_logpost, ej.current_logpost, rtol=1e-8)
    assert_allclose(gt.theta.get_data(), ej.theta.get_data(), atol=1e-6)
    _, _, q = _duplicated()
    rj, rt = mj.predict(q), mt.predict(q)
    assert_allclose(rt.mean, rj.mean, atol=1e-6)
    assert_allclose(rt.unc, rj.unc, atol=1e-6)

    Xd, Yd, _ = _duplicated(seed=4)
    np.random.seed(11)
    gd = mogp_tpu_torch.fit_GP_MAP(Xd, Yd, nugget="pivot", n_tries=3, maxiter=20, device="cpu")
    assert int(gd.Kinv.rank) == 20 and np.isfinite(gd.current_logpost)
    again = mogp_tpu_torch.GaussianProcess(Xd, Yd, nugget="pivot", device="cpu")
    assert again.logposterior(gd.theta.get_data()) == gd.current_logpost


def test_pivot_gp_and_mogp_survive_a_checkpoint(tmp_path):
    X, Y, q = _duplicated(seed=5)
    gp = mogp_tpu_torch.GaussianProcess(X, Y, nugget="pivot", device="cpu")
    gp.fit(np.array([0.1, -0.3, 0.2, 0.4]))
    save_gp(gp, tmp_path / "gp")
    back = load_gp(tmp_path / "gp", device="cpu")
    assert back.nugget_type == "pivot"
    assert back.current_logpost == gp.current_logpost
    assert_array_equal(back.predict(q).unc, gp.predict(q).unc)

    mgp = mogp_tpu_torch.MultiOutputGP(X, np.stack([Y, -Y]), nugget="pivot", device="cpu")
    mgp.fit(np.array([[0.1, -0.3, 0.2, 0.4], [0.0, 0.2, -0.1, 0.3]]))
    save_mogp(mgp, tmp_path / "mgp")
    mback = load_mogp(tmp_path / "mgp", device="cpu")
    assert [em.nugget_type for em in mback.emulators] == ["pivot", "pivot"]
    r0, r1 = mgp.predict(q), mback.predict(q)
    assert_array_equal(r1.mean, r0.mean)
    assert_array_equal(r1.unc, r0.unc)


def test_pivoted_lane_never_reaches_predict_fused(monkeypatch):
    """The fused kernel solves with an unpermuted factor and no rank mask:
    every predict of a pivot emulator (single, tiled, multi-output, the
    history-matching device sweep) must take the unfused route, although
    its shape is on the fused route.  The same emulator with the adaptive
    nugget does reach it."""
    from mogp_tpu_torch.uq import history_matching as hm_mod

    X, Y, q = _duplicated(seed=6)
    gt = mogp_tpu_torch.GaussianProcess(X, Y, nugget="pivot", device="cpu")
    gt.fit(np.zeros(4))
    assert tgp._predict_route(gt._data, gt.kernel) == "fused"
    assert tgp._predict_route(gt._data, gt.kernel, nugget_type="pivot") == "unfused"

    calls = []
    real = pf.predict_fused

    def guarded(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(pf, "predict_fused", guarded)
    ref = gt.predict(q)
    tiled = gt.predict(np.tile(q, (60, 1)), max_batch_size=256)
    assert_allclose(tiled.unc[:7], ref.unc, atol=1e-14)
    mgp = mogp_tpu_torch.MultiOutputGP(X, np.stack([Y, -Y]), nugget="pivot", device="cpu")
    mgp.fit(np.zeros((2, 4)))
    mgp.predict(q)
    monkeypatch.setattr(hm_mod, "_DEVICE_SWEEP_MIN_COORDS", 1)
    hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=[[0.1, 0.2], [0.01, 0.01]], coords=q)
    hm.get_implausibility(rank=1)
    assert calls == []

    ga = mogp_tpu_torch.GaussianProcess(X[:20], Y[:20], nugget="adaptive", device="cpu")
    ga.fit(np.zeros(4))
    ga.predict(q)
    assert calls == [1]
