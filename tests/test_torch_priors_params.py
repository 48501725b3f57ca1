"""The port's priors, parameters and design matrices against the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

from mogp_tpu.models import meanfun as jmf  # noqa: E402
from mogp_tpu.models import params as jpar  # noqa: E402
from mogp_tpu.models import priors as jpri  # noqa: E402
from mogp_tpu.ops.transforms import CorrTransform as JCorr  # noqa: E402
from mogp_tpu_torch.models import meanfun as tmf  # noqa: E402
from mogp_tpu_torch.models import params as tpar  # noqa: E402
from mogp_tpu_torch.models import priors as tpri  # noqa: E402
from mogp_tpu_torch.ops.transforms import CorrTransform as TCorr  # noqa: E402

torch.set_num_threads(2)

# float64 elementwise formulas written the same way in both packages
# (lgamma from torch vs jax.scipy: a few ulps)
RTOL, ATOL = 1e-12, 1e-12


@pytest.mark.parametrize("nugget_type", ["fit", "adaptive"])
@pytest.mark.parametrize("dist", ["invgamma", "gamma", "lognormal"])
def test_default_priors_packed_equal(nugget_type, dist):
    rng = np.random.RandomState(0)
    inputs = np.column_stack([rng.rand(15), rng.rand(15) * 10.0, np.repeat([0.0, 1.0, 2.0], 5)])
    got = tpri.GPPriors.default_priors(inputs, 3, nugget_type=nugget_type, dist=dist).packed()
    ref = jpri.GPPriors.default_priors(inputs, 3, nugget_type=nugget_type, dist=dist).packed()
    for g, r in zip(got, ref):
        assert_array_equal(g, r)


def test_dist_logp_all_codes():
    rng = np.random.RandomState(1)
    codes = np.repeat(np.arange(5), 4).astype(np.int32)
    a = rng.uniform(0.5, 3.0, size=codes.size)
    b = rng.uniform(0.5, 3.0, size=codes.size)
    x = rng.uniform(0.1, 4.0, size=codes.size)
    ref = np.asarray(jax.vmap(jpri.dist_logp)(jnp.asarray(codes), jnp.asarray(a),
                                              jnp.asarray(b), jnp.asarray(x)))
    got = tpri.dist_logp(torch.as_tensor(codes), torch.as_tensor(a), torch.as_tensor(b),
                         torch.as_tensor(x))
    assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[codes == 0] == 0.0)


def test_dist_logp_gradient_mixed_codes():
    """Value and gradient on a mixed Normal / LogNormal / Gamma / InvGamma /
    weak vector: a branch that is not picked must not poison the gradient
    (a Normal prior's mean is outside the Gamma branch's domain)."""
    codes = np.array([1, 4, 0, 3, 2, 1, 3], dtype=np.int32)
    a = np.array([0.0, 2.0, 1.0, 2.0, 0.8, -1.5, 0.7])
    b = np.array([1.0, 1.5, 1.0, 1.2, 2.0, 0.5, 3.0])
    x = np.array([0.5, 1.3, 2.0, 0.7, 1.1, 0.2, 2.5])
    args = [jnp.asarray(v) for v in (codes, a, b)]

    def total(xv):
        return jnp.sum(jax.vmap(jpri.dist_logp)(*args, xv))

    ref_val = np.asarray(jax.vmap(jpri.dist_logp)(*args, jnp.asarray(x)))
    ref_grad = np.asarray(jax.grad(total)(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    val = tpri.dist_logp(torch.as_tensor(codes), torch.as_tensor(a), torch.as_tensor(b), xt)
    (grad,) = torch.autograd.grad(val.sum(), xt)
    assert np.isfinite(grad.numpy()).all()
    assert_allclose(val.detach().numpy(), ref_val, rtol=RTOL, atol=ATOL)
    assert_allclose(grad.numpy(), ref_grad, rtol=RTOL, atol=ATOL)


_DISTS = [
    ("NormalPrior", (0.3, 1.5)),
    ("LogNormalPrior", (0.8, 2.0)),
    ("GammaPrior", (2.0, 1.2)),
    ("InvGammaPrior", (3.0, 2.0)),
    ("WeakPrior", ()),
]


@pytest.mark.parametrize("name,args", _DISTS)
def test_prior_objects_match(name, args):
    pj, pt = getattr(jpri, name)(*args), getattr(tpri, name)(*args)
    assert pt.code == pj.code and pt.packed_params == pj.packed_params
    for x in (0.4, 1.7):
        assert_allclose(float(pt.logp(x)), float(pj.logp(x)), rtol=RTOL, atol=ATOL)
        assert_allclose(pt.dlogpdx(x), float(pj.dlogpdx(x)), rtol=1e-10, atol=ATOL)
        assert_allclose(pt.d2logpdx2(x), float(pj.d2logpdx2(x)), rtol=1e-10, atol=ATOL)
        assert_allclose(pt.dlogpdtheta(x, TCorr), pj.dlogpdtheta(x, JCorr), rtol=1e-10, atol=ATOL)
        assert_allclose(pt.d2logpdtheta2(x, TCorr), pj.d2logpdtheta2(x, JCorr),
                        rtol=1e-10, atol=ATOL)


def test_gppriors_logp_and_derivatives():
    kw = dict(
        corr=[("LogNormalPrior", (0.8, 2.0)), ("GammaPrior", (2.0, 1.2))],
        cov=("InvGammaPrior", (3.0, 2.0)),
        nugget=("NormalPrior", (0.1, 0.5)),
    )

    def build(mod):
        return mod.GPPriors(
            corr=[getattr(mod, n)(*a) for n, a in kw["corr"]],
            cov=getattr(mod, kw["cov"][0])(*kw["cov"][1]),
            nugget=getattr(mod, kw["nugget"][0])(*kw["nugget"][1]),
            nugget_type="fit",
        )

    gj, gt = build(jpri), build(tpri)
    raw = np.array([0.2, -0.4, 0.3, -1.1])
    thj, tht = jpar.GPParams(n_corr=2, nugget="fit"), tpar.GPParams(n_corr=2, nugget="fit")
    thj.set_data(raw)
    tht.set_data(raw)
    assert_allclose(gt.logp(tht), gj.logp(thj), rtol=RTOL, atol=ATOL)
    assert_allclose(gt.dlogpdtheta(tht), gj.dlogpdtheta(thj), rtol=1e-10, atol=ATOL)
    assert_allclose(gt.d2logpdtheta2(tht), gj.d2logpdtheta2(thj), rtol=1e-10, atol=ATOL)


def test_mean_priors_match():
    mean, cov = np.array([1.0, -2.0]), np.array([[2.0, 0.3], [0.3, 1.0]])
    for c in (cov, np.array([2.0, 1.0]), 1.5):
        mj, mt = jpri.MeanPriors(mean, c), tpri.MeanPriors(mean, c)
        assert_allclose(mt.inv_cov(), np.asarray(mj.inv_cov()), rtol=RTOL)
        assert_allclose(mt.inv_cov_b(), np.asarray(mj.inv_cov_b()), rtol=RTOL)
        assert_allclose(mt.logdet_cov(), mj.logdet_cov(), rtol=RTOL)
    dm = np.random.RandomState(2).rand(5, 2)
    assert_allclose(tpri.MeanPriors(mean, cov).dm_dot_b(dm),
                    np.asarray(jpri.MeanPriors(mean, cov).dm_dot_b(jnp.asarray(dm))), rtol=RTOL)
    assert tpri.MeanPriors().has_weak_priors and tpri.MeanPriors().n_params == 0


@pytest.mark.parametrize("nugget", ["fit", "adaptive", "pivot", 0.25])
def test_gpparams_round_trip(nugget):
    pj, pt = jpar.GPParams(n_mean=2, n_corr=3, nugget=nugget), tpar.GPParams(
        n_mean=2, n_corr=3, nugget=nugget)
    assert pt.n_params == pj.n_params and pt.cov_index == pj.cov_index
    raw = np.linspace(-1.0, 1.0, pt.n_params)
    pt.set_data(raw)
    pj.set_data(raw)
    assert_array_equal(pt.get_data(), raw)
    assert_allclose(pt.corr, pj.corr, rtol=RTOL)
    assert_allclose(pt.cov, pj.cov, rtol=RTOL)
    assert pt.nugget == pj.nugget
    pt.mean = [0.5, 1.5]
    assert_array_equal(pt.mean, [0.5, 1.5])
    pt.corr = [1.0, 2.0, 3.0]
    assert_allclose(pt.corr, [1.0, 2.0, 3.0], rtol=RTOL)
    pt.cov = 2.0
    assert_allclose(pt.cov, 2.0, rtol=RTOL)
    if nugget == "fit":
        pt.nugget = 0.01
        assert_allclose(pt.nugget, 0.01, rtol=RTOL)
    assert pt.same_shape(pj.get_data()) and pt.same_shape(tpar.GPParams(2, 3, nugget))
    assert tpar._process_nugget(nugget) == jpar._process_nugget(nugget)


@pytest.mark.parametrize("formula", [
    None, "1", "x[0] + x[1]", "y ~ x[0]*x[1] - 1", "x[0] + I(x[1]**2) + log(x[2] + 1)",
    "C(x[2])", "x[0]:C(x[2])",
])
def test_design_matrix_matches(formula):
    rng = np.random.RandomState(4)
    x = np.column_stack([rng.rand(12), rng.rand(12), np.repeat([0.0, 1.0, 2.0], 4)])
    st, sj = {}, {}
    assert_array_equal(tmf.design_matrix(formula, x, state=st), jmf.design_matrix(formula, x, state=sj))
    assert tmf.n_mean_params(formula, 3, state=st) == jmf.n_mean_params(formula, 3, state=sj)
    if formula is not None:
        assert tmf.parse_formula(formula) == jmf.parse_formula(formula)


def test_sample_raw_moments_match_the_distributions():
    """``GPPriors.sample_raw`` draws each slot from its distribution
    (``mogp_tpu/models/priors.py:104-130``): the transformed draws' mean and
    variance match the family's analytic moments within 5 standard errors,
    and a weak slot's raw draws are uniform on [-2.5, 2.5]."""
    priors = tpri.GPPriors(
        corr=[tpri.NormalPrior(1.0, 0.1), tpri.LogNormalPrior(0.3, 0.5),
              tpri.GammaPrior(3.0, 0.5), tpri.InvGammaPrior(6.0, 2.0), None],
        cov=tpri.GammaPrior(2.0, 1.5), nugget_type="fit", nugget=tpri.InvGammaPrior(7.0, 1.0))
    n = 40000
    raw = priors.sample_raw(torch.Generator().manual_seed(0), n=n).numpy()
    assert raw.shape == (n, 7)
    assert priors.sample_raw(torch.Generator().manual_seed(0)).shape == (7,)
    x = np.concatenate([np.exp(-0.5 * raw[:, :5]), np.exp(raw[:, 5:])], axis=1)
    x[:, 4] = raw[:, 4]
    ln = (np.exp(0.3**2 / 2) * 0.5, 0.5**2 * (np.exp(0.3**2) - 1) * np.exp(0.3**2))
    moments = [(1.0, 0.01), ln, (1.5, 0.75), (2.0 / 5, 4.0 / (25 * 4)), (0.0, 25.0 / 12),
               (3.0, 4.5), (1.0 / 6, 1.0 / (36 * 5))]
    for slot, (mean, var) in enumerate(moments):
        xs = x[:, slot]
        m4 = np.mean((xs - xs.mean()) ** 4)
        assert abs(xs.mean() - mean) < 5 * np.sqrt(var / n), slot
        assert abs(xs.var() - var) < 5 * np.sqrt((m4 - xs.var() ** 2) / n), slot
    assert -2.5 <= raw[:, 4].min() and raw[:, 4].max() <= 2.5
    # the same coded families and parameters as the JAX package's
    jprs = jpri.GPPriors(
        corr=[jpri.NormalPrior(1.0, 0.1), jpri.LogNormalPrior(0.3, 0.5),
              jpri.GammaPrior(3.0, 0.5), jpri.InvGammaPrior(6.0, 2.0), None],
        cov=jpri.GammaPrior(2.0, 1.5), nugget_type="fit", nugget=jpri.InvGammaPrior(7.0, 1.0))
    for got, ref in zip(priors.packed(), jprs.packed()):
        np.testing.assert_array_equal(got, ref)
