"""The port's kernel-matrix build against the JAX package.

``kernel_matrix_plain`` (what the wrapper runs on a CPU tensor) is held
against ``mogp_tpu``'s Pallas kernel in interpret mode, as
``tests/test_pallas.py`` runs it, and the kernel classes' ``kernel_f`` /
``kernel_f_predict`` against their JAX counterparts.  The CUDA kernel
itself is compared with the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from mogp_tpu.ops import kernels as jk  # noqa: E402
from mogp_tpu.ops.pallas_kernels import pallas_kernel_matrix  # noqa: E402
from mogp_tpu_torch.ops import kernel_matrix as km  # noqa: E402
from mogp_tpu_torch.ops import kernels as tk  # noqa: E402

torch.set_num_threads(2)

# float64 on both sides; the Pallas body and the port's plain version both
# use the matmul form |z1|^2 + |z2|^2 - 2 z1.z2, so they differ only in
# summation order: a few ulps of |z|^2 (~D) in r2.
RTOL, ATOL = 1e-10, 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("base", ["sqexp", "mat52"])
@pytest.mark.parametrize("shape", [(50, 37, 3), (130, 200, 14), (5, 5, 1)])
def test_plain_matches_pallas_interpret(base, shape):
    n, m, D = shape
    rng = np.random.RandomState(0)
    z1, z2 = rng.rand(n, D), rng.rand(m, D)
    ref = np.asarray(pallas_kernel_matrix(jnp.asarray(z1), jnp.asarray(z2),
                                          base=base, interpret=True))
    got = km.kernel_matrix(_t(z1)[None], _t(z2), torch.ones(1, D, dtype=torch.float64),
                           torch.ones(1, dtype=torch.float64), base=base)
    assert got.shape == (1, n, m)
    assert_allclose(got[0].numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("base", ["sqexp", "mat52"])
def test_batched_lanes_match_loop_of_jax_calls(base):
    L, n, m, D = 4, 23, 31, 5
    rng = np.random.RandomState(1)
    x1, x2 = rng.rand(L, n, D), rng.rand(m, D)
    theta = rng.uniform(-1, 1, size=(L, D))
    sigma2 = np.exp(rng.uniform(-0.5, 0.5, size=L))
    got = km.kernel_matrix(_t(x1), _t(x2), _t(np.exp(theta)), _t(sigma2), base=base)
    for lane in range(L):
        scale = np.sqrt(np.exp(theta[lane]))
        ref = sigma2[lane] * np.asarray(pallas_kernel_matrix(
            jnp.asarray(x1[lane] * scale), jnp.asarray(x2 * scale),
            base=base, interpret=True))
        assert_allclose(got[lane].numpy(), ref, rtol=RTOL, atol=ATOL)


def test_mat52_diagonal_exactly_one():
    ones = torch.ones(1, 4, dtype=torch.float64), torch.ones(1, dtype=torch.float64)
    # small integers: the matmul form is exact, r2 is exactly 0 on the
    # diagonal, and the guard gives exactly 1
    z = _t(np.random.RandomState(2).randint(0, 8, size=(20, 4)))
    K = km.kernel_matrix(z[None], z, *ones, base="mat52")
    assert torch.equal(torch.diagonal(K[0]), torch.ones(20, dtype=torch.float64))
    # random inputs: the matmul form leaves r2 a few ulps of |z|^2 above 0
    # (the CUDA kernel's difference form is exact; chip_smoke.py checks it)
    z = _t(np.random.RandomState(2).rand(20, 4))
    K = km.kernel_matrix(z[None], z, *ones, base="mat52")
    assert_allclose(torch.diagonal(K[0]).numpy(), 1.0, rtol=0, atol=1e-12)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x1 = torch.zeros(2, 5, 3, dtype=torch.float64)
    x2 = torch.zeros(4, 3, dtype=torch.float64)
    et = torch.ones(2, 3, dtype=torch.float64)
    s2 = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError):
        km.kernel_matrix(x1[0], x2, et, s2)  # no lanes axis
    with pytest.raises(TypeError):
        km.kernel_matrix(x1.float(), x2, et, s2)  # mixed dtypes
    with pytest.raises(TypeError):
        km.kernel_matrix(x1.half(), x2.half(), et.half(), s2.half())
    with pytest.raises(ValueError):
        km.kernel_matrix(x1, torch.zeros(3, 4, dtype=torch.float64).T, et, s2)
    with pytest.raises(ValueError):
        km.kernel_matrix(x1, x2, et, s2, base="rbf")
    # the launch counter counts CUDA launches only
    before = km.launches
    km.kernel_matrix(x1, x2, et, s2)
    assert km.launches == before


_KERNELS = ["SquaredExponential", "UniformSqExp", "Matern52", "UniformMat52", "ProductMat52"]


@pytest.mark.parametrize("name", _KERNELS)
def test_kernel_f_and_predict_match_jax(name):
    rng = np.random.RandomState(3)
    x1, x2 = rng.uniform(size=(9, 4)), rng.uniform(size=(7, 4))
    jkern, tkern = jk.get_kernel(name), tk.get_kernel(name)
    p = rng.uniform(-0.5, 0.5, size=1 if jkern.form == "uniform" else 4)
    ref = np.asarray(jkern.kernel_f(x1, x2, p))
    assert_allclose(tkern.kernel_f(x1, x2, p).numpy(), ref, rtol=RTOL, atol=ATOL)
    assert_allclose(tkern.kernel_f_predict(x1, x2, p).numpy(), ref, rtol=RTOL, atol=ATOL)
    # lanes: per-lane parameters and sigma2, one call
    P = rng.uniform(-0.5, 0.5, size=(3, p.size))
    s2 = np.exp(rng.uniform(-0.5, 0.5, size=3))
    got = tkern.kernel_f_predict(_t(np.stack([x1] * 3)), _t(x2), _t(P), _t(s2))
    for lane in range(3):
        assert_allclose(got[lane].numpy(), s2[lane] * np.asarray(jkern.kernel_f(x1, x2, P[lane])),
                        rtol=RTOL, atol=ATOL)
    if jkern.form == "product":
        d2 = np.asarray(jkern.calc_r2(x1, x2, p))
        assert_allclose(tkern.calc_r2(x1, x2, p).numpy(), d2, rtol=RTOL, atol=ATOL)


def test_training_distance_has_an_exact_zero_diagonal_in_float32():
    """``K(x, x)``'s squared distances at correlation lengths of ~1e-2 in
    unit inputs, where ``|z|^2`` ~ 4e4: the diagonal is exactly 0 in
    float32 (the matmul form alone leaves a few ulps of ``|z|^2`` there),
    and the rest within float32's cancellation of ``|z|^2`` of the direct
    differences in float64."""
    rng = np.random.RandomState(5)
    x = rng.uniform(size=(3, 40, 14))
    et = np.exp(9.5 + 0.2 * rng.normal(size=(3, 14)))
    x32 = torch.as_tensor(x, dtype=torch.float32)
    r2 = tk.squared_distance(x32, x32, torch.as_tensor(et, dtype=torch.float32)).numpy()
    ref = np.sum((x[:, :, None, :] - x[:, None, :, :]) ** 2 * et[:, None, None, :], axis=-1)
    assert np.all(np.diagonal(r2, axis1=1, axis2=2) == 0.0)
    sq = np.sum(x**2 * et[:, None, :], axis=-1)
    tol = 16 * np.finfo(np.float32).eps * (sq[:, :, None] + sq[:, None, :])
    assert np.all(np.abs(r2 - ref) <= tol)
    K = tk.SquaredExponential().kernel_f(x32, x32, torch.as_tensor(np.log(et), dtype=torch.float32))
    assert np.all(np.diagonal(K.numpy(), axis1=1, axis2=2) == 1.0)
