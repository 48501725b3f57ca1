"""The port's kernel derivatives (``KernelBase.kernel_deriv`` /
``kernel_hessian``, forward mode through ``torch.func.jacfwd``) against
``mogp_tpu``'s (``jax.jacfwd``), in float64 on the CPU.

Parity at ``rtol`` 1e-12, with an absolute floor of 1e-12 of the largest
entry: where the exact value is 0 (coincident points) ``mogp_tpu``'s
matmul-form distance leaves a rounding residue of ~1e-16 and the port an
exact 0.  Then the ports of ``tests/test_kernels.py:82-110`` and
``tests/test_kernels_oracle.py:80-150``: the hand value, the
finite-difference grids, the Hessian's symmetry and finiteness at zero
distance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from mogp_tpu.ops import kernels as jk  # noqa: E402
from mogp_tpu_torch.ops import kernels as tk  # noqa: E402

torch.set_num_threads(2)

NAMES = ["SquaredExponential", "Matern52", "UniformSqExp", "UniformMat52", "ProductMat52"]
RTOL = 1e-12

_rng = np.random.RandomState(1234)
X1 = _rng.uniform(-2, 2, size=(7, 3))
X2 = _rng.uniform(-2, 2, size=(5, 3))
PARAMS = _rng.uniform(-1, 1, size=3)


def _params(kernel, D=3, seed=0):
    p = np.random.RandomState(seed).uniform(-0.7, 0.7, size=D)
    return p[:1] if kernel.form == "uniform" else p


def _close(got, ref):
    assert got.shape == ref.shape
    assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("same", [False, True], ids=["cross", "training"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_deriv_matches_mogp_tpu(name, same):
    kt, kj = tk.get_kernel(name), jk.get_kernel(name)
    p = _params(kt)
    x2 = X1 if same else X2
    _close(kt.kernel_deriv(X1, x2, p).numpy(), np.asarray(kj.kernel_deriv(X1, x2, p)))


@pytest.mark.parametrize("same", [False, True], ids=["cross", "training"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_hessian_matches_mogp_tpu(name, same):
    kt, kj = tk.get_kernel(name), jk.get_kernel(name)
    p = _params(kt, seed=1)
    x2 = X1 if same else X2
    _close(kt.kernel_hessian(X1, x2, p).numpy(), np.asarray(kj.kernel_hessian(X1, x2, p)))


@pytest.mark.parametrize("name", NAMES)
def test_training_diagonal_derivative_is_exactly_zero_in_float32(name):
    """The same array twice keeps its identity through ``_coerce``, so the
    diagonal's distance is an exact 0 and so is its derivative, in float32
    too (numpy input and a tensor alike)."""
    kt = tk.get_kernel(name)
    p = _params(kt).astype(np.float32)
    for x in (X1.astype(np.float32), torch.tensor(X1, dtype=torch.float32)):
        d = kt.kernel_deriv(x, x, p)
        h = kt.kernel_hessian(x, x, p)
        assert d.dtype == torch.float32 and torch.isfinite(h).all()
        idx = np.arange(len(X1))
        assert (d[:, idx, idx] == 0).all() and (h[:, :, idx, idx] == 0).all()


def test_deriv_with_tensors_inputs():
    """Tensor inputs and parameters give the numpy inputs' values."""
    k = tk.SquaredExponential()
    a = k.kernel_deriv(X1, X2, PARAMS)
    b = k.kernel_deriv(torch.tensor(X1), torch.tensor(X2), torch.tensor(PARAMS))
    assert torch.equal(a, b)


# -- tests/test_kernels.py:82-110 ---------------------------------------------

@pytest.mark.parametrize(
    "kernel", [tk.SquaredExponential(), tk.Matern52(), tk.UniformSqExp(), tk.ProductMat52()]
)
def test_kernel_deriv_matches_fd(kernel):
    params = PARAMS[: (1 if kernel.form == "uniform" else 3)]
    deriv = kernel.kernel_deriv(X1, X2, params).numpy()
    assert deriv.shape == (len(params), len(X1), len(X2))
    eps = 1e-6
    for i in range(len(params)):
        pp = params.copy()
        pp[i] += eps
        pm = params.copy()
        pm[i] -= eps
        fd = (kernel.kernel_f(X1, X2, pp).numpy() - kernel.kernel_f(X1, X2, pm).numpy()) / (2 * eps)
        assert_allclose(deriv[i], fd, rtol=1e-5, atol=1e-7)


def test_deriv_finite_at_zero_distance():
    """Matern autodiff must be NaN-free on the diagonal (r2 = 0)."""
    deriv = tk.Matern52().kernel_deriv(X1, X1, PARAMS).numpy()
    assert np.all(np.isfinite(deriv))
    assert_allclose(deriv[:, np.arange(len(X1)), np.arange(len(X1))], 0.0, atol=1e-12)


def test_kernel_hessian_shape():
    hess = tk.Matern52().kernel_hessian(X1, X2, PARAMS).numpy()
    assert hess.shape == (3, 3, len(X1), len(X2))
    assert np.all(np.isfinite(hess))


# -- tests/test_kernels_oracle.py:80-150 ---------------------------------------

X1P = np.array([[1.0, 2.0]])
X2P = np.array([[0.0, 0.0]])
THETA = np.array([0.0, np.log(4.0)])

_grid_rng = np.random.RandomState(99)
XA = _grid_rng.uniform(-1.5, 1.5, size=(6, 2))
XB = _grid_rng.uniform(-1.5, 1.5, size=(4, 2))


def _n_params(kernel, D=2):
    return 1 if kernel.form == "uniform" else D


def test_sqexp_deriv_hand_value():
    """d/dtheta_d exp(-r2/2) = -0.5 * exp(theta_d) (x1_d-x2_d)^2 * K."""
    K = np.exp(-0.5 * 17.0)
    expect = np.array([-0.5 * 1.0 * 1.0 * K, -0.5 * 4.0 * 4.0 * K])
    deriv = tk.SquaredExponential().kernel_deriv(X1P, X2P, THETA).numpy()
    assert_allclose(deriv[:, 0, 0], expect, rtol=1e-10)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_deriv_fd_grid(name):
    kernel = tk.get_kernel(name)
    params = np.random.RandomState(3).uniform(-0.7, 0.7, size=_n_params(kernel))
    deriv = kernel.kernel_deriv(XA, XB, params).numpy()
    eps = 1e-6
    for i in range(len(params)):
        pp, pm = params.copy(), params.copy()
        pp[i] += eps
        pm[i] -= eps
        fd = (kernel.kernel_f(XA, XB, pp).numpy() - kernel.kernel_f(XA, XB, pm).numpy()) / (2 * eps)
        assert_allclose(deriv[i], fd, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_hessian_fd_grid(name):
    """Hessian[i, j] vs central FD of kernel_deriv[j] wrt param i, and the
    Hessian's symmetry in (i, j)."""
    kernel = tk.get_kernel(name)
    params = np.random.RandomState(4).uniform(-0.5, 0.5, size=_n_params(kernel))
    P = len(params)
    hess = kernel.kernel_hessian(XA, XB, params).numpy()
    assert hess.shape == (P, P, len(XA), len(XB))
    eps = 1e-5
    for i in range(P):
        pp, pm = params.copy(), params.copy()
        pp[i] += eps
        pm[i] -= eps
        fd = (kernel.kernel_deriv(XA, XB, pp).numpy()
              - kernel.kernel_deriv(XA, XB, pm).numpy()) / (2 * eps)
        for j in range(P):
            assert_allclose(hess[i, j], fd[j], rtol=5e-4, atol=5e-6)
    assert_allclose(hess, np.swapaxes(hess, 0, 1), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_symmetry_and_psd(name):
    kernel = tk.get_kernel(name)
    params = np.random.RandomState(5).uniform(-0.5, 0.5, size=_n_params(kernel))
    K = kernel.kernel_f(XA, XA, params).numpy()
    assert_allclose(K, K.T, rtol=1e-10, atol=1e-12)
    assert np.linalg.eigvalsh(K).min() > -1e-9
    assert_allclose(np.diag(K), 1.0, rtol=1e-10)
    assert np.all(K <= 1.0 + 1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_hessian_finite_at_zero_distance(name):
    kernel = tk.get_kernel(name)
    params = np.random.RandomState(6).uniform(-0.5, 0.5, size=_n_params(kernel))
    hess = kernel.kernel_hessian(XA, XA, params).numpy()
    assert np.all(np.isfinite(hess))
