"""The serving slice end to end, port against the JAX package.

``GaussianProcess`` and ``MultiOutputGP`` are built in both packages on
the same data (n = 30, D = 3, 4 outputs, 200 queries), fit at the same
hyperparameters and asked for predictions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.models import gp as jgp  # noqa: E402
from mogp_tpu.utils.checkpoint import save_gp, save_mogp  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402

torch.set_num_threads(2)

# float64 on both sides, same algorithm; LAPACK (torch) and XLA factor and
# solve in different rounding orders, and the condition number of K
# amplifies that: up to ~1e8 for the long-lengthscale output, whose exact
# factorization fails so that the adaptive nugget takes the 1e-6 jitter
# rung.  Agreement there is ~1e-9 of each quantity's scale, elsewhere
# ~1e-12; ATOL is relative to the largest reference value.
RTOL, ATOL = 1e-7, 1e-8

N, D, OUT, Q = 30, 3, 4, 200


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(N, D)
    y = np.stack([
        np.sin(3.0 * x[:, 0]) + x[:, 1],
        x[:, 2] ** 2 - x[:, 0],
        np.cos(x.sum(axis=1)),
        x[:, 0] * x[:, 1] + 0.1 * rng.randn(N),
    ])
    return x, y, rng.rand(Q, D)


def _thetas(rng, n_params, n=OUT):
    th = np.empty((n, n_params))
    th[:, :D] = rng.uniform(0.5, 2.5, size=(n, D))
    th[:, D:] = rng.uniform(-0.5, 0.5, size=(n, n_params - D))
    th[-1, :D] = -8.0  # long lengthscales: K singular in float64, adaptive needs jitter
    return th


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert_allclose(got, ref, rtol=RTOL, atol=ATOL * scale)


def _same_fit(et, ej):
    _close(et.current_logpost, ej.current_logpost)
    if ej.nugget_type == "adaptive":
        assert_allclose(et.nugget, ej.nugget, rtol=1e-12, atol=0)
    else:
        assert et.nugget == pytest.approx(ej.nugget, rel=1e-14)
    _close(np.asarray(et.theta.mean), np.asarray(ej.theta.mean))


NUGGETS = ["adaptive", "fit", 1e-4]
MEANS = [None, "x[0] + x[1]"]


@pytest.mark.parametrize("nugget", NUGGETS)
@pytest.mark.parametrize("mean", MEANS)
def test_gaussian_process_fit_predict(mean, nugget):
    x, y, q = _data()
    gj = mogp_tpu.GaussianProcess(x, y[3], mean=mean, nugget=nugget)
    gt = mogp_tpu_torch.GaussianProcess(x, y[3], mean=mean, nugget=nugget, device="cpu")
    th = _thetas(np.random.RandomState(1), gj.n_params)[-1 if nugget == "adaptive" else 0]
    gj.fit(th)
    gt.fit(th)
    _same_fit(gt, ej=gj)
    if nugget == "adaptive":
        assert gt.nugget > 0.0  # the jitter rung, not the exact factorization
    for full_cov in (False, True):
        rj = gj.predict(q, full_cov=full_cov)
        rt = gt.predict(q, full_cov=full_cov)
        _close(rt.mean, rj.mean)
        _close(rt.unc, rj.unc)
    _close(gt.predict(q, unc=False, include_nugget=False)[0], gj(q))


@pytest.mark.parametrize("nugget", NUGGETS)
@pytest.mark.parametrize("mean", MEANS)
def test_multi_output_gp_fit_predict(mean, nugget):
    x, y, q = _data()
    mj = mogp_tpu.MultiOutputGP(x, y, mean=mean, nugget=nugget)
    mt = mogp_tpu_torch.MultiOutputGP(x, y, mean=mean, nugget=nugget, device="cpu")
    th = _thetas(np.random.RandomState(2), mj.emulators[0].n_params)
    mj.fit(th)
    # a plain numpy array as taken from the JAX emulators
    mt.fit(np.array([em.theta.get_data() for em in mj.emulators]))
    for et, ej in zip(mt.emulators, mj.emulators):
        _same_fit(et, ej)
    rj, rt = mj.predict(q), mt.predict(q)
    _close(rt.mean, rj.mean)
    _close(rt.unc, rj.unc)


def test_tiled_prediction_matches():
    """Query counts above the tile go through ``gp_predict_tiled``; the last
    tile is padded by repeating the final query."""
    x, y, _ = _data()
    q = np.random.RandomState(5).rand(300, D)
    mj = mogp_tpu.MultiOutputGP(x, y, mean="x[0]")
    mt = mogp_tpu_torch.MultiOutputGP(x, y, mean="x[0]", device="cpu")
    th = _thetas(np.random.RandomState(3), mj.emulators[0].n_params)
    mj.fit(th)
    mt.fit(th)
    rj = mj.predict(q, max_batch_size=256)
    rt = mt.predict(q, max_batch_size=256)
    _close(rt.mean, rj.mean)
    _close(rt.unc, rj.unc)
    # the lanes-level function against the JAX one, tile not a divisor of m
    em = mt.emulators[0]
    dm = em.get_design_matrix(q)
    mu_t, var_t = tgp.gp_predict_tiled(
        em._artifacts, em._data, em._tensor(q), em._tensor(dm), em.kernel, em.nugget_type,
        tile=64,
    )
    ej = mj.emulators[0]
    mu_j, var_j = jgp.gp_predict_tiled(
        ej._artifacts, ej._data, q, dm, ej.kernel, ej.nugget_type, tile=64,
    )
    _close(mu_t[0].numpy(), np.asarray(mu_j))
    _close(var_t[0].numpy(), np.asarray(var_j))


def test_same_width_formulas_do_not_share_a_group():
    """Two emulators with different formulas of the same width: each must
    predict with its own design matrix."""
    x, y, q = _data()
    means = ["x[0]", "x[1]", "x[0]", "x[2]"]
    mj = mogp_tpu.MultiOutputGP(x, y, mean=means)
    mt = mogp_tpu_torch.MultiOutputGP(x, y, mean=means, device="cpu")
    assert len(mt._groups()) == 3
    th = _thetas(np.random.RandomState(4), mj.emulators[0].n_params)
    mj.fit(th)
    mt.fit(th)
    rj, rt = mj.predict(q), mt.predict(q)
    _close(rt.mean, rj.mean)
    _close(rt.unc, rj.unc)


def test_every_kernel_through_the_slice():
    x, y, q = _data()
    kernels = ["SquaredExponential", "Matern52", "UniformMat52", "ProductMat52"]
    mj = mogp_tpu.MultiOutputGP(x, y, kernel=kernels)
    mt = mogp_tpu_torch.MultiOutputGP(x, y, kernel=kernels, device="cpu")
    rng = np.random.RandomState(6)
    th = [rng.uniform(0.0, 1.0, size=em.n_params) for em in mj.emulators]
    mj.fit(th)
    mt.fit(th)
    for et, ej in zip(mt.emulators, mj.emulators):
        _same_fit(et, ej)
    rj, rt = mj.predict(q), mt.predict(q)
    _close(rt.mean, rj.mean)
    _close(rt.unc, rj.unc)


def test_checkpoints_written_by_mogp_tpu_load_in_the_port(tmp_path):
    x, y, q = _data()
    mj = mogp_tpu.MultiOutputGP(x, y, mean=[None, "x[0]", None, "x[1] + x[2]"],
                                nugget=["adaptive", "fit", 1e-3, "adaptive"])
    th = [_thetas(np.random.RandomState(7), em.n_params, n=1)[0] for em in mj.emulators]
    for i in (0, 1, 3):
        mj.fit_emulator(i, th[i])
    path = str(tmp_path / "mogp.npz")
    save_mogp(mj, path)
    mt = mogp_tpu_torch.load_mogp(path, device="cpu")
    assert mt.get_indices_not_fit() == mj.get_indices_not_fit() == [2]
    for i in (0, 1, 3):
        _same_fit(mt.emulators[i], mj.emulators[i])
    rj = mj.predict(q, allow_not_fit=True)
    rt = mt.predict(q, allow_not_fit=True)
    assert np.isnan(rt.mean[2]).all()
    _close(rt.mean[[0, 1, 3]], rj.mean[[0, 1, 3]])
    _close(rt.unc[[0, 1, 3]], rj.unc[[0, 1, 3]])

    gj = mj.emulators[1]
    gpath = str(tmp_path / "gp.npz")
    save_gp(gj, gpath)
    gt = mogp_tpu_torch.load_gp(gpath, device="cpu")
    _same_fit(gt, gj)
    _close(gt.predict(q).mean, gj.predict(q).mean)
    assert_array_equal(gt.theta.get_data(), gj.theta.get_data())


def test_unfit_and_bad_arguments_raise():
    x, y, q = _data()
    gt = mogp_tpu_torch.GaussianProcess(x, y[0], device="cpu")
    with pytest.raises(ValueError):
        gt.predict(q)
    with pytest.raises(AssertionError):
        gt.fit(np.zeros(gt.n_params + 1))
    with pytest.raises(ValueError):
        mogp_tpu_torch.GaussianProcess(x, y[0], kernel="NotAKernel", device="cpu")
    # nugget="pivot" fits now (tests/test_torch_pivot.py); its nugget
    # cannot be set, as in mogp_tpu
    gp = mogp_tpu_torch.GaussianProcess(x, y[0], nugget="pivot", device="cpu")
    gp.fit(np.zeros(gp.n_params))
    with pytest.raises(ValueError):
        gp.theta.nugget = 1e-3
