"""The universal-kriging emulator of the port against the repository's plain
reference (``tests/ref_universal_kriging.py``), on the CPU: the Matern 5/2
kernel, a linear mean with a normal prior (M = D + 1 terms), a fitted nugget
and proper priors on every hyperparameter (Example 3 of
``demos/gp_demos.py``), at n = 24, D = 3, M = 4 and 4 outputs, seeded.

Tolerances (``TOL``), by type:

* float64: the port and the reference compute the same numbers in another
  order (half-solves against ``cholesky_solve``), so they part at the
  rounding of a few hundred operations on matrices of condition ~1e6;
* float32: the port in float32 against the reference in float64, so the
  rounding of float32 at that condition, about ten times the largest gap
  seen on ten seeds of this data (the fitted winner's, 0.05 nats, the
  largest: the fit drives the nugget down to where ``K``'s condition is
  highest).

:func:`test_each_tolerance_fails_under_a_fault` shows that each tolerance is
tight enough to see a fault: the reference with ``log det A`` dropped (the
objective), with ``B^-1`` left out of ``A`` (the mean and the prediction),
or in float32 with its products rounded to TF32 (every quantity; at this
nugget TF32 rounding leaves ``K`` no longer positive definite in most
lanes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mogp_tpu_torch as mt  # noqa: E402
import ref_universal_kriging as R  # noqa: E402
from mogp_tpu_torch.models import fitting  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402
from mogp_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(2)

N, D, E = 24, 3, 4
M = D + 1
MEAN = "+".join("x[{}]".format(d) for d in range(D))
PRIORS = R.prior_arrays(D)
DTYPES = [torch.float64, torch.float32]

_rng = np.random.RandomState(20261018)
X = _rng.uniform(size=(N, D))
Y = np.stack([np.sin(X @ _rng.randn(D) + e) + 0.3 * (X**2).sum(1) + _rng.randn()
              + X @ _rng.randn(D) for e in range(E)]) + 0.01 * _rng.randn(E, N)
RAW = np.concatenate([_rng.uniform(-2.0, 0.5, (E, D)), _rng.uniform(-1.0, 0.5, (E, 1)),
                      _rng.uniform(-9.0, -6.0, (E, 1))], axis=1)
Q = _rng.uniform(size=(300, D))
OBS = [_rng.randn(E), _rng.uniform(0.01, 0.05, E)]

# largest |port - reference| allowed, by quantity and type (module doc)
TOL = {
    torch.float64: {"nlp": 1e-9, "grad": 1e-8, "beta": 1e-9, "mu": 1e-9, "var": 1e-10,
                    "I": 1e-9, "winner": 1e-9},
    torch.float32: {"nlp": 1e-2, "grad": 1.5e-2, "beta": 5e-4, "mu": 5e-4, "var": 4e-5,
                    "I": 4e-3, "winner": 0.5},
}

def _priors():
    P = mt.Priors
    return P.GPPriors(mean=P.MeanPriors(mean=PRIORS["mean"], cov=PRIORS["mean_cov"]),
                      corr=[P.LogNormalPrior(*row) for row in PRIORS["corr"]],
                      cov=P.InvGammaPrior(*PRIORS["cov"]), nugget=P.GammaPrior(*PRIORS["nugget"]),
                      nugget_type="fit")


def _model(dtype, mean=MEAN):
    return mt.MultiOutputGP(X, Y, mean=mean, kernel="Matern52",
                            priors=_priors() if mean else None, nugget="fit", device="cpu",
                            dtype=dtype)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ref_args(dtype, mm):
    """The reference's tensors: float64, or float32 under TF32 products."""
    rd = torch.float32 if mm is R.tf32_mm else torch.float64
    return _t(RAW, rd), _t(X, rd), _t(Y, rd)


def _ref_grad(dtype, mm, leave_out):
    raw, x, y = _ref_args(dtype, mm)
    raw.requires_grad_(True)
    (g,) = torch.autograd.grad(R.nlp(raw, x, y, PRIORS, mm, leave_out).sum(), raw)
    return g


def _port_nlp_grad(dtype):
    mgp = _model(dtype)
    data = tgp.cat_lanes([em._data for em in mgp.emulators])
    raw = _t(RAW, dtype).requires_grad_(True)
    v = tgp.gp_nlp(raw, data, mgp.emulators[0].kernel, "fit")
    (g,) = torch.autograd.grad(v.sum(), raw)
    return v.detach(), g


def _quantity(name, dtype, mm=torch.matmul, leave_out=()):
    """``(port, reference)`` of one compared quantity, float64 numpy."""
    if name in ("nlp", "grad"):
        v, g = _port_nlp_grad(dtype)
        ref = (R.nlp(*_ref_args(dtype, mm), PRIORS, mm, leave_out) if name == "nlp"
               else _ref_grad(dtype, mm, leave_out))
        port = v if name == "nlp" else g
    elif name == "beta":
        mgp = _model(dtype)
        mgp.fit(RAW)
        port = np.stack([em.theta.mean for em in mgp.emulators])
        ref = R.posterior(*_ref_args(dtype, mm), PRIORS, mm, leave_out)["beta"]
    elif name in ("mu", "var"):
        mgp = _model(dtype)
        mgp.fit(RAW)
        mu, var, _ = mgp.predict(Q)
        raw, x, y = _ref_args(dtype, mm)
        rmu, rvar = R.predict(raw, x, y, PRIORS, _t(Q, raw.dtype), mm, leave_out)
        port, ref = (mu, rmu) if name == "mu" else (var, rvar)
    elif name == "I":
        mgp = _model(dtype)
        mgp.fit(RAW)
        port = mt.HistoryMatching(gp=mgp, obs=OBS, coords=Q).get_implausibility(rank=1)
        raw, x, y = _ref_args(dtype, mm)
        mu, var = R.predict(raw, x, y, PRIORS, _t(Q, raw.dtype), mm, leave_out)
        ref = R.rank_implausibility(mu, var, _t(OBS[0], raw.dtype), _t(OBS[1], raw.dtype), 1)
    elif name == "winner":
        mgp = _model(dtype)
        np.random.seed(7)
        mt.fit_GP_MAP(mgp, n_tries=4, maxiter=30)
        theta = np.stack([em.theta.get_data() for em in mgp.emulators])
        port = np.array([em.current_logpost for em in mgp.emulators])
        rd = torch.float32 if mm is R.tf32_mm else torch.float64
        ref = R.nlp(_t(theta, rd), _t(X, rd), _t(Y, rd), PRIORS, mm, leave_out)
    else:
        raise KeyError(name)
    as_np = [np.asarray(a.detach().double() if isinstance(a, torch.Tensor) else a, float)
             for a in (port, ref)]
    return as_np[0], as_np[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(TOL[torch.float64]))
def test_port_against_the_reference(name, dtype):
    port, ref = _quantity(name, dtype)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    assert np.abs(port - ref).max() <= TOL[dtype][name], np.abs(port - ref).max()


# each compared quantity, under the faults that reach it: log det A
# dropped (the objective), B^-1 left out (the mean and the prediction), TF32
# products (all of them)
FAULTS = [(name, dtype, fault) for name in TOL[torch.float64] for dtype in DTYPES
          for fault in (("logdet_A", "tf32") if name in ("nlp", "grad", "winner")
                        else ("B_inv", "tf32"))]


@pytest.mark.parametrize("name,dtype,fault", FAULTS)
def test_each_tolerance_fails_under_a_fault(name, dtype, fault):
    kw = {"mm": R.tf32_mm} if fault == "tf32" else {"leave_out": (fault,)}
    port, ref = _quantity(name, dtype, **kw)
    assert np.nan_to_num(np.abs(port - ref), nan=np.inf).max() > TOL[dtype][name]


def test_restart_draws_are_the_references():
    mgp = _model(torch.float64)
    np.random.seed(123)
    starts = np.stack([fitting._gather_starts(em, 6, None) for em in mgp.emulators])
    assert np.array_equal(starts, R.restart_points(PRIORS, E, 6, 123))
    # a fit with no iteration ends on one of them, emulator by emulator
    np.random.seed(123)
    mt.fit_GP_MAP(mgp, n_tries=6, maxiter=0, race=False, refit=True)
    theta = np.stack([em.theta.get_data() for em in mgp.emulators])
    assert np.isclose(theta[:, None, :], starts, rtol=1e-12, atol=0).all(-1).any(-1).all()


@pytest.mark.parametrize("raw_cov,raw_nugget", [(-9.0, -40.0), (-7.0, -30.0)])
def test_float32_quadratic_form_where_the_mean_explains_the_targets(raw_cov, raw_nugget):
    # short correlation lengths and a tiny covariance: K ~ sigma2 I, and a
    # linear mean that explains y but for 1e-2 noise; |alpha|^2 less the
    # mean's share cancels ~1e6 in float32, ~0.1-0.3 nats off, where
    # |alpha - Wh d|^2 + d^T B^-1 d (ops/linalg.py) stays within 1e-4
    rng = np.random.RandomState(0)
    x = rng.uniform(size=(40, D))
    c = 3.0 * rng.randn(M)
    y = c[0] + x @ c[1:] + 0.01 * rng.randn(40)
    raw = np.concatenate([np.full(D, 10.0), [raw_cov, raw_nugget]])
    gp = mt.GaussianProcess(x, y, mean=MEAN, kernel="Matern52", priors=_priors(), nugget="fit",
                            device="cpu", dtype=torch.float32)
    got = tgp.gp_nlp(_t(raw, torch.float32)[None], gp._data, gp.kernel, "fit")[0]
    ref = R.nlp(_t(raw)[None], _t(x), _t(y)[None], PRIORS)[0]
    assert abs(float(got) - float(ref)) <= 1e-2


def test_graphed_fit_admits_the_configuration():
    # on a card the MAP fit of this model replays CUDA graphs: K2 at the
    # tsunami widths' n = 210 and at A's M = 15, the one-rung ladder, the
    # fitted nugget
    assert fitting._graphed("cuda", 210, torch.float32, "single", "fit")
    assert kb.route(210, torch.float32) == kb.route(15, torch.float32) == "k2"
    assert not fitting._graphed("cpu", 210, torch.float32, "single", "fit")
    assert pf.route("cuda", 210, 15, "stationary", False, torch.float32) == "fused"


@pytest.mark.parametrize("mean,terms", [(MEAN, M), (None, 0)])
def test_the_mean_span_and_counter(mean, terms):
    mgp = _model(torch.float64, mean=mean)
    data = tgp.cat_lanes([em._data for em in mgp.emulators])
    kernel = mgp.emulators[0].kernel
    raw = _t(RAW)
    metrics.clear()
    tgp.gp_nlp(raw, data, kernel, "fit")
    assert metrics.counters() == {} and metrics.spans() == []   # off: nothing
    with metrics.recording():
        tgp.gp_nlp(raw, data, kernel, "fit")
        mgp.fit(RAW)
    counters, names = metrics.counters(), [s.name for s in metrics.spans()]
    metrics.clear()
    assert counters["gp.nlp_lanes"] == E
    # the objective's and the fit's mean branch, where there is a mean
    assert names.count("gp.mean") == (2 if terms else 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_an_informative_mean_prior_away_from_zero(dtype):
    # b != 0: beta = A^-1 (H^T K^-1 y + B^-1 b) = b + A^-1 H^T K^-1 (y - H b);
    # the coefficients and the predictive mean, not the objective alone
    pr = dict(PRIORS, mean=np.array([0.5, 1.0, -2.0, 0.3]), mean_cov=np.array([0.3, 2.0, 1.5, 0.7]))
    P = mt.Priors
    priors = P.GPPriors(mean=P.MeanPriors(mean=pr["mean"], cov=pr["mean_cov"]),
                        corr=[P.LogNormalPrior(*row) for row in pr["corr"]],
                        cov=P.InvGammaPrior(*pr["cov"]), nugget=P.GammaPrior(*pr["nugget"]),
                        nugget_type="fit")
    mgp = mt.MultiOutputGP(X, Y, mean=MEAN, kernel="Matern52", priors=priors, nugget="fit",
                           device="cpu", dtype=dtype)
    mgp.fit(RAW)
    post = R.posterior(_t(RAW), _t(X), _t(Y), pr)
    mu, var, _ = mgp.predict(Q)
    rmu, rvar = R.predict(_t(RAW), _t(X), _t(Y), pr, _t(Q))
    tol = TOL[dtype]
    assert np.abs(np.stack([em.theta.mean for em in mgp.emulators])
                  - post["beta"].numpy()).max() <= tol["beta"]
    assert np.abs(np.array([em.current_logpost for em in mgp.emulators])
                  - post["nlp"].numpy()).max() <= tol["nlp"]
    assert np.abs(mu - rmu.numpy()).max() <= tol["mu"]
    assert np.abs(var - rvar.numpy()).max() <= tol["var"]
