"""Mean-function objects, the formula parser, ``utils.misc`` and ``compat``
of the port against ``mogp_tpu``.

``MeanFunction`` trees are built in both packages from the same formulas
and operators, and evaluated with their derivatives (``torch.func.jacfwd``
in the port, ``jax.jacfwd`` in mogp_tpu) on the same seeded inputs in
float64: the values and derivatives are the same arithmetic, so they agree
to rounding (``rtol`` 1e-12, ``atol`` 1e-12 for entries that are zero in
one package and rounding in the other).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu import compat as jcompat  # noqa: E402
from mogp_tpu.models import formula as jf  # noqa: E402
from mogp_tpu.models import meanfunction as jm  # noqa: E402
from mogp_tpu.utils import misc as jmisc  # noqa: E402
from mogp_tpu_torch import compat as tcompat  # noqa: E402
from mogp_tpu_torch.models import formula as tf  # noqa: E402
from mogp_tpu_torch.models import meanfunction as tm  # noqa: E402
from mogp_tpu_torch.utils import misc as tmisc  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-12, 1e-12
X = np.random.RandomState(0).uniform(0.1, 1.0, size=(8, 3))

FORMULAS = [
    ("y = a + b*x[0]", {}),
    ("c*a*b", {"a": 0, "b": 1}),
    ("1 + x[0]^2", {}),
    ("(x[0] + x[1])*2", {}),
    ("a + b*x[0] + c*x[1]^2", {}),
    ("x[0]^2^2", {}),
    ("I(x[0]) + a", {}),
    ("(a + b*x[0])(x[0]*x[1])", {}),
    ("a*x[1]^b", {}),
    ("width + c*height", {"width": 0, "height": 2}),
    ("~ inputs[2]**2", {}),
]


def _trees(mod):
    """Trees built with the operators, one per node type."""
    return [
        mod.Coefficient() + mod.Coefficient() * mod.LinearMean(0),
        mod.Coefficient() * mod.LinearMean(0) + mod.Coefficient() * mod.LinearMean(2) ** 2.0,
        mod.Coefficient() * mod.Coefficient(),
        mod.PolynomialMean(2),
        (mod.LinearMean(0) ** 2.0)(mod.Coefficient() * mod.LinearMean(1)),
        mod.FixedMean(lambda x: x[:, 0] ** 3) * mod.Coefficient() + 2.0,
        3.0 * mod.LinearMean(1) + mod.ConstantMean(0.5),
        mod.LinearMean(2) ** mod.Coefficient(),
    ]


def _same_everywhere(mj, mt):
    assert str(mt) == str(mj)
    n = mj.get_n_params(X)
    assert mt.get_n_params(X) == n
    params = np.random.RandomState(n).uniform(0.5, 1.5, size=n)
    for name in ("__call__", "mean_deriv", "mean_hessian", "mean_inputderiv"):
        a = getattr(mj, name)(X, params)
        b = getattr(mt, name)(X, params)
        assert isinstance(b, np.ndarray)
        assert b.shape == np.shape(a), name
        assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("i", range(8))
def test_mean_trees_and_derivatives(i):
    _same_everywhere(_trees(jm)[i], _trees(tm)[i])


@pytest.mark.parametrize("formula,inputdict", FORMULAS)
def test_formulas_and_derivatives(formula, inputdict):
    mj = jm.MeanFunction(formula, inputdict)
    mt = tm.MeanFunction(formula, inputdict)
    assert type(mt).__name__ == type(mj).__name__
    _same_everywhere(mj, mt)
    _same_everywhere(jf.mean_from_patsy_formula(formula, inputdict),
                     tf.mean_from_patsy_formula(formula, inputdict))


@pytest.mark.parametrize("bad", ["a + (b", "call + x[0]", "a + + b", "", "x[0] ]", "I + a",
                                 "I(I)", "x", "x[-1]", "q[0]", 1, None])
def test_formula_errors_are_the_same(bad):
    with pytest.raises(Exception) as ej:
        jf.mean_from_string(bad)
    with pytest.raises(type(ej.value)):
        tf.mean_from_string(bad)


def test_meanfunction_factory_and_operator_errors():
    assert isinstance(mogp_tpu_torch.MeanFunction(None), tm.ConstantMean)
    mf = mogp_tpu_torch.MeanFunction("a + b*x[0]")
    assert mogp_tpu_torch.MeanFunction(mf) is mf
    for mod in (jm, tm):
        with pytest.raises(ValueError):
            mod.MeanFunction(1.5)
        with pytest.raises(TypeError):
            mod.LinearMean(0) + "a"
        with pytest.raises(TypeError):
            mod.LinearMean(0) ** "a"
        with pytest.raises(AssertionError):
            mod.Coefficient()(X, np.array([1.0, 2.0]))
        with pytest.raises(NotImplementedError):
            mod.MeanBase().mean_f(X, np.array([]))
    # one-dimensional inputs are one column
    assert_allclose(tm.LinearMean(0)(X[:, 1], []), jm.LinearMean(0)(X[:, 1], []), rtol=0)


def test_misc_k_fold_and_integer_bisect():
    for K, randomise, items in [(3, False, list(range(10))), (4, True, list(range(12))),
                                (2, False, np.arange(12.0).reshape(6, 2))]:
        np.random.seed(70)
        a = list(jmisc.k_fold_cross_validation(items, K, randomise=randomise))
        np.random.seed(70)
        b = list(tmisc.k_fold_cross_validation(items, K, randomise=randomise))
        assert len(a) == len(b) == K
        for (ta, va), (tb, vb) in zip(a, b):
            assert_allclose(np.asarray(tb), np.asarray(ta), rtol=0)
            assert_allclose(np.asarray(vb), np.asarray(va), rtol=0)
    for bound, f in [((0, 100), lambda n: n - 6), ((3, 4), lambda n: n - 3),
                     ((-50, 50), lambda n: n * n * np.sign(n) - 200)]:
        assert tmisc.integer_bisect(bound, f) == jmisc.integer_bisect(bound, f)


def test_compat_aliases():
    assert tcompat.GaussianProcessGPU is mogp_tpu_torch.GaussianProcess
    assert tcompat.MultiOutputGP_GPU is mogp_tpu_torch.MultiOutputGP
    for alias in (tcompat.StationaryKernel, tcompat.UniformKernel, tcompat.ProductKernel):
        assert alias is mogp_tpu_torch.Kernel.KernelBase
    assert issubclass(tcompat.GPUUnavailableError, RuntimeError)
    assert tcompat.gpu_usable() is torch.cuda.is_available()
    r2 = np.array([0.0, 1.0, 4.0])
    for name in ("SqExpBase", "Mat52Base"):
        ref = np.asarray(getattr(jcompat, name).calc_K(r2))
        assert_allclose(getattr(tcompat, name).calc_K(torch.tensor(r2)).numpy(), ref, rtol=1e-15)
    x = np.random.RandomState(30).rand(12, 2)
    gp = tcompat.GaussianProcessGPU(x, np.sin(3 * x[:, 0]), device="cpu")
    gp.fit(np.zeros(3))
    assert np.isfinite(gp.predict(x[:3]).mean).all()


def test_compat_gpu_usable_follows_torch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcompat.gpu_usable() is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcompat.gpu_usable() is False
