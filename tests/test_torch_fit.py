"""The MAP objective and the batched optimizer of the port against the JAX package.

``gp_nlp`` with its autograd gradient against ``jax.value_and_grad(gp_nlp)``,
``GaussianProcess.logpost_deriv`` / ``logpost_hessian`` against
``mogp_tpu``'s, and the lanes-first ``lbfgs_minimize`` against
``jax.vmap(lbfgs_minimize)``, all in float64 on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.models import gp as jgp  # noqa: E402
from mogp_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.ops.lbfgs import lbfgs_minimize  # noqa: E402

torch.set_num_threads(2)

# float64 on both sides, same formulas; K at these (short) lengthscales has
# condition < 1e4, so the two factorizations' rounding-order difference
# stays near 1e-12 in the objective and its gradient
RTOL, ATOL = 1e-9, 1e-10

N, D = 20, 3


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(N, D)
    y = np.sin(3.0 * x[:, 0]) + x[:, 1] ** 2 - x[:, 2] + 0.05 * rng.randn(N)
    return x, y


def _raws(gp, n=3, seed=1):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.5, 0.5, size=(n, gp.n_params))
    th[:, :gp.n_corr] = rng.uniform(0.5, 2.5, size=(n, gp.n_corr))  # lengthscales ~0.3-0.8
    return th


KERNELS = ["SquaredExponential", "Matern52", "UniformMat52", "ProductMat52"]
NUGGETS = ["adaptive", "fit", 1e-3]
MEANS = [None, "x[0]"]


@pytest.mark.parametrize("nugget", NUGGETS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mean", MEANS)
def test_gp_nlp_value_and_grad_match_jax(mean, kernel, nugget):
    x, y = _data()
    gj = mogp_tpu.GaussianProcess(x, y, mean=mean, kernel=kernel, nugget=nugget)
    gt = mogp_tpu_torch.GaussianProcess(x, y, mean=mean, kernel=kernel, nugget=nugget,
                                        device="cpu")
    raws = _raws(gj)
    data = tgp.take_lanes(gt._data, torch.zeros(len(raws), dtype=torch.int64))
    rt = torch.as_tensor(raws).requires_grad_(True)
    val = tgp.gp_nlp(rt, data, gt.kernel, gt.nugget_type)
    (grad,) = torch.autograd.grad(val.sum(), rt)
    vg = jax.jit(jax.value_and_grad(jgp.gp_nlp), static_argnums=(2, 3))
    for lane, raw in enumerate(raws):
        vj, gj_ = vg(jnp.asarray(raw), gj._data, gj.kernel, gj.nugget_type)
        assert_allclose(val[lane].item(), float(vj), rtol=RTOL, atol=ATOL)
        assert_allclose(grad[lane].numpy(), np.asarray(gj_), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ladder", [True, "single"])
def test_gp_nlp_trajectory_ladders_match_jax(ladder):
    x, y = _data(1)
    gj = mogp_tpu.GaussianProcess(x, y, nugget="adaptive")
    gt = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cpu")
    raws = _raws(gj, seed=2)
    data = tgp.take_lanes(gt._data, torch.zeros(len(raws), dtype=torch.int64))
    rt = torch.as_tensor(raws).requires_grad_(True)
    val = tgp.gp_nlp(rt, data, gt.kernel, "adaptive", sparse_ladder=ladder, progressive_ok=False)
    (grad,) = torch.autograd.grad(val.sum(), rt)

    def f(r):
        return jgp.gp_nlp(r, gj._data, gj.kernel, "adaptive", sparse_ladder=ladder,
                          progressive_ok=False)

    vg = jax.jit(jax.value_and_grad(f))
    for lane, raw in enumerate(raws):
        vj, gj_ = vg(jnp.asarray(raw))
        assert_allclose(val[lane].item(), float(vj), rtol=RTOL, atol=ATOL)
        assert_allclose(grad[lane].numpy(), np.asarray(gj_), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nugget,mean", [("adaptive", None), ("fit", "x[0] + x[1]"),
                                         (1e-3, None)])
def test_logpost_deriv_and_hessian_match_jax(nugget, mean):
    x, y = _data(2)
    gj = mogp_tpu.GaussianProcess(x, y, mean=mean, nugget=nugget)
    gt = mogp_tpu_torch.GaussianProcess(x, y, mean=mean, nugget=nugget, device="cpu")
    theta = _raws(gj, n=1, seed=3)[0]
    assert_allclose(gt.logposterior(theta), gj.logposterior(theta), rtol=RTOL)
    assert_allclose(gt.logpost_deriv(theta), gj.logpost_deriv(theta), rtol=RTOL, atol=ATOL)
    h = gt.logpost_hessian(theta)
    assert_allclose(h, gj.logpost_hessian(theta), rtol=1e-8, atol=1e-8 * np.abs(h).max())
    assert_allclose(h, h.T, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# lbfgs_minimize: lanes first against jax.vmap
# ---------------------------------------------------------------------------

def _quadratic_batch(L=4, P=5, seed=0):
    rng = np.random.RandomState(seed)
    Q = rng.randn(L, P, P)
    H = Q @ np.transpose(Q, (0, 2, 1)) + 0.5 * np.eye(P)
    c = rng.randn(L, P)
    x0 = rng.randn(L, P)
    return H, c, x0


def _rosen_t(x):
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, dim=-1)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _compare(res_t, res_j):
    # the same decisions in every lane (iteration counts, convergence);
    # the iterates carry the two packages' summation-order rounding, which
    # the Rosenbrock valley amplifies to ~1e-9 over 40 iterations
    assert_array_equal(res_t.n_iter.numpy(), np.asarray(res_j.n_iter))
    assert_array_equal(res_t.converged.numpy(), np.asarray(res_j.converged))
    ok = np.isfinite(np.asarray(res_j.fun))
    assert_array_equal(np.isfinite(res_t.fun.numpy()), ok)
    assert_allclose(res_t.x.numpy()[ok], np.asarray(res_j.x)[ok], rtol=1e-9, atol=1e-10)
    assert_allclose(res_t.fun.numpy()[ok], np.asarray(res_j.fun)[ok], rtol=1e-8, atol=1e-10)


def test_lbfgs_quadratic_batch_matches_vmap():
    H, c, x0 = _quadratic_batch()
    x0[2] = np.nan  # a lane that starts at NaN stops at once
    Ht, ct = torch.as_tensor(H), torch.as_tensor(c)

    def f(x):
        return 0.5 * torch.einsum("lp,lpq,lq->l", x, Ht, x) - torch.sum(ct * x, dim=-1)

    res_t = lbfgs_minimize(f, torch.as_tensor(x0), maxiter=60)
    res_j = jax.vmap(lambda x, h, cc: jax_lbfgs(lambda z: 0.5 * z @ h @ z - cc @ z, x,
                                                 maxiter=60))(
        jnp.asarray(x0), jnp.asarray(H), jnp.asarray(c))
    _compare(res_t, res_j)
    assert int(res_t.n_iter[2]) == 0 and not bool(res_t.converged[2])
    good = [0, 1, 3]
    assert bool(res_t.converged[good].all())
    assert_allclose(res_t.x[good].numpy(), np.linalg.solve(H[good], c[good][..., None])[..., 0],
                    rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_linesearch", [2, 5])
def test_lbfgs_rosenbrock_batch_matches_vmap(max_linesearch):
    rng = np.random.RandomState(1)
    x0 = rng.uniform(-2.0, 2.0, size=(5, 3))
    x0[3] = [np.nan, 0.0, 1.0]
    res_t = lbfgs_minimize(_rosen_t, torch.as_tensor(x0), maxiter=40,
                           max_linesearch=max_linesearch)
    res_j = jax.vmap(lambda x: jax_lbfgs(_rosen_j, x, maxiter=40,
                                         max_linesearch=max_linesearch))(jnp.asarray(x0))
    _compare(res_t, res_j)
    # lanes reach different iteration counts: the lockstep loop keeps a
    # stopped lane's state while the others run on
    assert len(set(res_t.n_iter.tolist())) > 1


def test_lbfgs_nan_lane_touches_no_other_lane():
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-2.0, 2.0, size=(4, 3))
    alone = lbfgs_minimize(_rosen_t, torch.as_tensor(x0), maxiter=30)
    x0_nan = np.concatenate([x0[:2], np.full((1, 3), np.nan), x0[2:]])
    # the NaN lane's objective and gradient are NaN at every trial
    mixed = lbfgs_minimize(_rosen_t, torch.as_tensor(x0_nan), maxiter=30)
    keep = [0, 1, 3, 4]
    for field in ("x", "fun", "grad", "n_iter", "converged"):
        assert torch.equal(getattr(mixed, field)[keep], getattr(alone, field)), field
    assert torch.isnan(mixed.fun[2]) and int(mixed.n_iter[2]) == 0


def test_lbfgs_default_tolerances_follow_the_dtype():
    """float32 lanes converge on the float32 tolerances (gtol ~7e-4)."""
    H, c, x0 = _quadratic_batch(L=3, P=4, seed=3)
    Ht, ct = torch.as_tensor(H, dtype=torch.float32), torch.as_tensor(c, dtype=torch.float32)

    def f(x):
        return 0.5 * torch.einsum("lp,lpq,lq->l", x, Ht, x) - torch.sum(ct * x, dim=-1)

    res = lbfgs_minimize(f, torch.as_tensor(x0, dtype=torch.float32), maxiter=100)
    assert res.x.dtype == torch.float32 and bool(res.converged.all())
    assert int(res.n_iter.max()) < 100
