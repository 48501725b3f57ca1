"""Validation diagnostics of the port against ``mogp_tpu``: the cases of
``tests/test_uq.py:146-188,466-504`` (standard and pivoted errors,
Mahalanobis distances with their oracles, the scaled-F distribution, the
multi-output forms) through both packages on the same fitted emulators.

float64 on both sides.  The standard errors are the same numpy arithmetic
on predictions that agree to ~1e-12; the pivoted errors whiten with the
same pivoted Cholesky (``ops/cholesky.py``), in one batched call for all
outputs in the port where ``mogp_tpu`` loops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.uq import validation as jv  # noqa: E402
from mogp_tpu_torch.uq import validation as tv  # noqa: E402

torch.set_num_threads(2)

# The predictions agree to PRED_ATOL (targets and variances of scale ~1;
# LAPACK and XLA round in other orders, amplified by K's condition, ~1e7
# here, to 1.5e-12 in the means and 1e-12 in the variances, and to 2.7e-11
# in the multi-output means).  A standard error e = (mu - y) / sqrt(var)
# then agrees to PRED_ATOL (1 / sqrt(var) + |e| / var); a pivoted error
# whitens by the covariance's factor, so it agrees to cond(cov) PRED_ATOL
# max|e|; a Mahalanobis distance, a sum of their squares, to twice that
# relative.
PRED_ATOL = 1e-10


def _close_std(got, ref, var_sorted):
    bound = PRED_ATOL * (1.0 / np.sqrt(var_sorted) + np.abs(ref) / var_sorted)
    assert np.all(np.abs(got - ref) <= bound), (got, ref, bound)


def _close_piv(got, ref, cov):
    assert_allclose(got, ref, rtol=0,
                    atol=PRED_ATOL * np.linalg.cond(cov) * max(1.0, np.abs(ref).max()))


def _cond_rtol(cov):
    return 2 * PRED_ATOL * max(np.linalg.cond(c) for c in np.reshape(cov, (-1,) + cov.shape[-2:]))


def _gp(pkg):
    """tests/test_uq.py's fit_gp fixture at fixed hyperparameters."""
    rng = np.random.RandomState(20)
    x = rng.rand(25, 2) * 3
    y = np.sin(x[:, 0]) + np.cos(2 * x[:, 1])
    kw = {"device": "cpu"} if pkg is mogp_tpu_torch else {}
    gp = pkg.GaussianProcess(x, y, nugget=1e-6,
                             priors=pkg.GPPriors(n_corr=2, nugget_type="fixed"), **kw)
    gp.fit(np.array([-0.2, 0.1, 0.3]))
    return gp


def _mogp(pkg):
    rng = np.random.RandomState(23)
    x = rng.rand(20, 2)
    ys = np.stack([np.sin(3 * x[:, 0]), np.cos(3 * x[:, 1]), x[:, 0] * x[:, 1]])
    kw = {"device": "cpu"} if pkg is mogp_tpu_torch else {}
    mgp = pkg.MultiOutputGP(x, ys, **kw)
    mgp.fit(np.array([[0.5, -0.3, 0.2], [-0.1, 0.6, 0.0], [0.2, 0.2, -0.4]]))
    return mgp


def _valid(seed, n, gp_like):
    rng = np.random.RandomState(seed)
    xv = rng.uniform(size=(n, 2)) * (3 if gp_like else 1)
    if gp_like:
        return xv, np.sin(xv[:, 0]) + np.cos(2 * xv[:, 1])
    return xv, np.stack([np.sin(3 * xv[:, 0]), np.cos(3 * xv[:, 1]), xv[:, 0] * xv[:, 1]])


def test_standard_errors():
    xv, yv = _valid(21, 10, True)
    (ej, Pj), (et, Pt) = jv.standard_errors(_gp(mogp_tpu), xv, yv), \
        tv.standard_errors(_gp(mogp_tpu_torch), xv, yv)
    assert_array_equal(Pt, Pj)
    gt = _gp(mogp_tpu_torch)
    mu, var, _ = gt.predict(xv)
    _close_std(et, ej, var[Pt])
    assert_allclose(et, ((mu - yv) / np.sqrt(var))[np.argsort(var)[::-1]], rtol=1e-12)


def test_pivoted_errors_and_mahalanobis():
    gj, gt = _gp(mogp_tpu), _gp(mogp_tpu_torch)
    xv, yv = _valid(22, 10, True)
    ej, Pj = jv.pivoted_errors(gj, xv, yv)
    et, Pt = tv.pivoted_errors(gt, xv, yv)
    assert et.shape == (10,)
    assert_array_equal(Pt, Pj)
    mu, cov, _ = gt.predict(xv, full_cov=True)
    _close_piv(et, ej, cov)
    Mt = tv.mahalanobis(gt, xv, yv)
    assert_allclose(Mt, jv.mahalanobis(gj, xv, yv), rtol=_cond_rtol(cov))
    assert_allclose(Mt, np.sum(et**2), rtol=1e-12)
    assert_allclose(Mt, (mu - yv) @ np.linalg.solve(cov, mu - yv), rtol=1e-6)
    Ms = tv.mahalanobis(gt, xv, yv, scaled=True)
    assert np.ndim(Ms) == 0
    assert_allclose(Ms, jv.mahalanobis(gj, xv, yv, scaled=True), rtol=_cond_rtol(cov))


def test_validation_oracles_and_mahal_dist():
    """tests/test_uq.py:466-504 on the port, against mogp_tpu."""
    gj, gt = _gp(mogp_tpu), _gp(mogp_tpu_torch)
    rng = np.random.RandomState(17)
    xv = rng.uniform(size=(9, 2))
    yv = np.sin(3 * xv[:, 0]) + xv[:, 1] ** 2
    mu_f, cov, _ = gt.predict(xv, full_cov=True)
    expect_M = float((yv - mu_f) @ np.linalg.solve(cov, yv - mu_f))
    assert_allclose(tv.mahalanobis(gt, xv, yv), expect_M, rtol=1e-6)
    perr, _ = tv.pivoted_errors(gt, xv, yv)
    assert_allclose(np.sum(perr**2), expect_M, rtol=1e-6)
    dj, dt = jv.generate_mahal_dist(gj, rng.uniform(size=(11, 2))), \
        tv.generate_mahal_dist(gt, rng.uniform(size=(11, 2)))
    assert dt.stats() == dj.stats()
    assert abs(dt.mean() - 11.0) / 11.0 < 0.35
    with pytest.raises(TypeError):
        tv.generate_mahal_dist("not a gp", xv)
    with pytest.raises(AssertionError):
        tv.standard_errors(gt, xv, np.zeros(8))
    with pytest.raises(AssertionError):
        tv.standard_errors(gt, xv, np.zeros((2, 9)))


def test_multioutput_batched_pivot_errors():
    """All outputs' covariances in one batched pivoted Cholesky: the same
    errors and permutations as mogp_tpu's loop over outputs."""
    mj, mt = _mogp(mogp_tpu), _mogp(mogp_tpu_torch)
    xv, yv = _valid(24, 6, False)
    sj, st = jv.standard_errors(mj, xv, yv), tv.standard_errors(mt, xv, yv)
    pj, pt = jv.pivoted_errors(mj, xv, yv), tv.pivoted_errors(mt, xv, yv)
    assert len(st) == len(pt) == 3
    var = mt.predict(xv).unc
    cov = mt.predict(xv, full_cov=True).unc
    for i, ((a, Pa), (b, Pb)) in enumerate(zip(sj, st)):
        assert_array_equal(Pb, Pa)
        _close_std(b, a, var[i][Pb])
    for i, ((a, Pa), (b, Pb)) in enumerate(zip(pj, pt)):
        assert_array_equal(Pb, Pa)
        _close_piv(b, a, cov[i])
    for scaled in (False, True):
        Mt = tv.mahalanobis(mt, xv, yv, scaled=scaled)
        assert Mt.shape == (3,)
        assert_allclose(Mt, jv.mahalanobis(mj, xv, yv, scaled=scaled), rtol=_cond_rtol(cov))
    dists = tv.generate_mahal_dist(mt, xv)
    assert [d.stats() for d in dists] == [d.stats() for d in jv.generate_mahal_dist(mj, xv)]


def test_validation_of_a_pivot_nugget_emulator():
    """An emulator with nugget="pivot" on duplicated training inputs, the
    standard and pivoted errors and the Mahalanobis distance."""
    rng = np.random.RandomState(26)
    x = rng.rand(18, 2)
    x = np.vstack([x, x[:2]])
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    xv, yv = rng.rand(7, 2), rng.rand(7)
    out = []
    for pkg, v in ((mogp_tpu, jv), (mogp_tpu_torch, tv)):
        kw = {"device": "cpu"} if pkg is mogp_tpu_torch else {}
        gp = pkg.GaussianProcess(x, y, nugget="pivot", **kw)
        gp.fit(np.array([0.5, 0.8, 0.1]))
        out.append((v.standard_errors(gp, xv, yv), v.pivoted_errors(gp, xv, yv),
                    v.mahalanobis(gp, xv, yv), gp))
    (sj, pj, Mj, _), (st, pt, Mt, gt) = out
    var, cov = gt.predict(xv).unc, gt.predict(xv, full_cov=True).unc
    assert_array_equal(st[1], sj[1])
    _close_std(st[0], sj[0], var[st[1]])
    assert_array_equal(pt[1], pj[1])
    _close_piv(pt[0], pj[0], cov)
    assert_allclose(Mt, Mj, rtol=_cond_rtol(cov))


def test_pivot_errors_strategy_class():
    """PivotErrors called directly with device="cpu" (float64 there by
    default) on one output and on a stack of outputs; with no device it
    takes the card, as every entry point does, and raises without one."""
    rng = np.random.RandomState(4)
    A = rng.randn(3, 5, 5)
    cov = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(5)
    mean, target = rng.randn(3, 5), rng.randn(3, 5)
    method = tv.PivotErrors(device="cpu")
    assert method.dtype == torch.float64
    e_all, P_all = method(target, mean, cov)
    for i in range(3):
        ej, Pj = jv.PivotErrors()(target[i], mean[i], cov[i])
        assert_array_equal(P_all[i], Pj)
        assert_allclose(e_all[i], ej, rtol=1e-10, atol=1e-12)
    assert tv.PivotErrors.full_cov and not tv.StandardErrors.full_cov
    with pytest.raises(NotImplementedError):
        tv.Errors()(target, mean, cov)
    if torch.cuda.is_available():
        assert tv.PivotErrors().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tv.PivotErrors()


def test_compute_errors_runs_the_method_it_is_given():
    """compute_errors factors on the PivotErrors' own device and type: a
    float32 method on a float64 emulator rounds its errors to float32
    (within float32's epsilon times cond(cov), ~1e3 here, of the float64
    ones), which the float64 method given by pivoted_errors does not."""
    gt = _mogp(mogp_tpu_torch)
    xv, yv = _valid(24, 5, False)
    cov = gt.predict(xv, full_cov=True).unc
    ref = tv.pivoted_errors(gt, xv, yv)
    f64 = tv.compute_errors(gt, xv, yv, tv.PivotErrors(device="cpu", dtype=torch.float64))
    f32 = tv.compute_errors(gt, xv, yv, tv.PivotErrors(device="cpu", dtype=torch.float32))
    for (er, Pr), (e64, P64), (e32, _), c in zip(ref, f64, f32, cov):
        assert_array_equal(P64, Pr)
        assert_array_equal(e64, er)
        bound = np.finfo(np.float32).eps * np.linalg.cond(c) * np.abs(er).max()
        assert 0 < np.abs(e32 - er).max() <= bound
