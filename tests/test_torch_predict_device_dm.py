"""The prediction's mean design matrix built on the device, one query tile
at a time (``models/mogp.py::_queries``), against the host's
(``meanfun.design_matrix``), on the CPU.

The reference is the same emulators with the formula handed over as a
callable mean that returns ``meanfun.design_matrix`` of it: the training
design matrix, and so every fit artifact, is the same array, and a callable
mean takes the host path.  Both build every column in float64 from the
caller's float64 queries and round it once to the emulators' dtype, so the
predictions must be equal bit for bit, for every formula: linear terms, an
intercept, no mean, a square, a product, a categorical factor, and terms
with a jump at a query value (an indicator, a floor), where a float32 copy
of the queries would land on the other side of the jump.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mogp_tpu_torch as mt  # noqa: E402
from mogp_tpu_torch.models import meanfun  # noqa: E402
from mogp_tpu_torch.models import mogp as tmogp  # noqa: E402
from mogp_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(2)

N, D, E, Q = 30, 3, 3, 700
LEVELS = [0.0, 1.0, 2.0]

_rng = np.random.RandomState(20261018)
X = _rng.uniform(size=(N, D))
X[:, 1] = _rng.randint(0, 3, N)
Y = np.stack([np.sin(X @ _rng.randn(D) + e) + X @ _rng.randn(D) for e in range(E)])
RAW = np.concatenate([_rng.uniform(-1.0, 0.5, (E, D)), _rng.uniform(-0.5, 0.5, (E, 1)),
                      _rng.uniform(-9.0, -6.0, (E, 1))], axis=1)
XQ = _rng.uniform(size=(Q, D))
XQ[:, 1] = _rng.randint(0, 3, Q)
# queries on the jumps of "step" and "floor": float32(0.3) > 0.3 and
# 10 * float32(0.7) < 7, so a float32 copy of them jumps the other way
XQ[::5, 0] = 0.3
XQ[2::5, 0] = 0.7

EXACT = {
    "linear": "+".join("x[{}]".format(d) for d in range(D)),
    "intercept": "1",
    "zero": None,
    "categorical": "x[0] + C(x[1], levels={})".format(LEVELS),
    "step": "x[2] + I(x[0] > 0.3)",
    "floor": "x[2] + I(np.floor(10 * x[0]))",
}
COMPUTED = {
    "square": "x[0] + I(x[0]**2)",
    "product": "x[0]:x[1]",
}
FORMULAS = dict(EXACT, **COMPUTED)
DTYPES = [torch.float64, torch.float32]
# queries in tiles of 256 (3 tiles), all at once, all at once with full covariance
TILINGS = {"tiled": dict(max_batch_size=256), "untiled": {}, "full_cov": dict(full_cov=True)}
# tiled against untiled: the kernel's sums over other tile shapes
RTOL = {torch.float64: 1e-12, torch.float32: 2e-5}


def _fitted(mean, dtype):
    gp = mt.MultiOutputGP(X, Y, mean=mean, kernel="Matern52", nugget="fit", device="cpu",
                          dtype=dtype)
    gp.fit(RAW)
    return gp


def _host_reference(formula, dtype):
    """The same emulators with the formula as a callable: the host path."""
    return _fitted(lambda x: meanfun.design_matrix(formula, x), dtype)


def _counted_predict(gp, queries, **kw):
    metrics.clear()
    with metrics.recording():
        res = gp.predict(queries, **kw)
    counts = metrics.counters()
    metrics.clear()
    return res, counts


@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_numpy_queries_match_the_host_design_matrix(name, dtype, tiling):
    formula, kw = FORMULAS[name], TILINGS[tiling]
    queries = XQ[:300] if tiling == "full_cov" else XQ
    (mu, var, _), counts = _counted_predict(_fitted(formula, dtype), queries, **kw)
    (mu_h, var_h, _), counts_h = _counted_predict(_host_reference(formula, dtype), queries,
                                                   **kw)
    rows = 0 if name == "zero" else len(queries)
    assert counts == ({"predict.dm_rows_device": rows} if rows else {})
    assert counts_h == ({"predict.dm_rows_host": rows} if rows else {})
    assert np.isfinite(mu).all() and np.isfinite(var).all()
    np.testing.assert_array_equal(mu, mu_h)
    np.testing.assert_array_equal(var, var_h)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_tiled_and_untiled_agree(name, dtype):
    gp = _fitted(FORMULAS[name], dtype)
    mu_t, var_t, _ = gp.predict(XQ, max_batch_size=256)
    mu_u, var_u, _ = gp.predict(XQ)
    tol = RTOL[dtype]
    np.testing.assert_allclose(mu_t, mu_u, rtol=tol, atol=tol * np.abs(mu_u).max())
    np.testing.assert_allclose(var_t, var_u, rtol=tol, atol=tol * np.abs(var_u).max())


@pytest.mark.parametrize("tiling", ["tiled", "untiled"])
def test_each_tile_is_built_in_float64_from_its_own_queries(monkeypatch, tiling):
    """The columns are evaluated once a tile, on the caller's float64
    coordinates of the tile, and never over the whole query set."""
    seen = []
    real = tmogp.design_matrix_fn

    def spy(mean, state=None):
        fn = real(mean, state)

        def wrapped(x):
            seen.append(x.clone())
            return fn(x)
        return wrapped

    monkeypatch.setattr(tmogp, "design_matrix_fn", spy)
    gp = _fitted(EXACT["linear"], torch.float32)
    gp.predict(XQ, **TILINGS[tiling])
    assert [x.shape[0] for x in seen] == ([256, 256, Q - 512] if tiling == "tiled" else [Q])
    assert {x.dtype for x in seen} == {torch.float64}
    np.testing.assert_array_equal(torch.cat(seen).numpy(), XQ)


def test_a_callable_mean_keeps_the_host_path():
    formula = EXACT["linear"]
    calls = []

    def mean(x):
        calls.append(np.asarray(x).dtype)
        return meanfun.design_matrix(formula, x)

    gp = _fitted(mean, torch.float32)
    del calls[:]
    (mu_c, _, _), counts = _counted_predict(gp, XQ, max_batch_size=256)
    assert counts == {"predict.dm_rows_host": Q}
    assert calls == [np.float64]   # the caller's float64 queries, once, over the whole set
    (mu_f, _, _), _ = _counted_predict(_fitted(formula, torch.float32), XQ, max_batch_size=256)
    np.testing.assert_array_equal(mu_c, mu_f)


def test_the_zero_mean_counts_no_rows():
    _, counts = _counted_predict(_fitted(None, torch.float32), XQ, max_batch_size=256)
    assert "predict.dm_rows_device" not in counts and "predict.dm_rows_host" not in counts


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_an_unmatched_categorical_query_still_raises(dtype):
    gp = _fitted(EXACT["categorical"], dtype)
    bad = XQ[:10].copy()
    bad[3, 1] = 5.0
    with pytest.raises(ValueError, match="outside its bound"):
        gp.predict(bad)


def test_a_categorical_level_not_exact_in_float32_still_matches():
    """Levels 0.1, 0.2, 0.3 are not float32 numbers: float32 emulators build
    such a formula's columns on the device from the caller's float64
    queries, where they match exactly, as on the host; a float32 copy of
    the queries would match none."""
    rng = np.random.RandomState(5)
    x = X.copy()
    x[:, 1] = 0.1 * (1 + rng.randint(0, 3, N))
    q = XQ.copy()
    q[:, 1] = 0.1 * (1 + rng.randint(0, 3, Q))
    formula = "x[0] + C(x[1])"
    gp = mt.MultiOutputGP(x, Y, mean=formula, kernel="Matern52", nugget="fit", device="cpu",
                          dtype=torch.float32)
    gp.fit(RAW)
    (mu, var, _), counts = _counted_predict(gp, q, max_batch_size=256)
    assert counts == {"predict.dm_rows_device": Q}
    with pytest.raises(ValueError, match="outside its bound"):
        meanfun.design_matrix_fn(formula, gp.emulators[0]._mean_state)(
            torch.as_tensor(q, dtype=torch.float32).double())
    ref = mt.MultiOutputGP(x, Y, mean=lambda v: meanfun.design_matrix(formula, v, state=dict(
        gp.emulators[0]._mean_state)), kernel="Matern52", nugget="fit", device="cpu",
        dtype=torch.float32)
    ref.fit(RAW)
    mu_h, var_h, _ = ref.predict(q, max_batch_size=256)
    np.testing.assert_array_equal(mu, mu_h)
    np.testing.assert_array_equal(var, var_h)


@pytest.mark.parametrize("name", ["step", "floor"])
def test_a_jump_at_a_query_is_taken_as_on_the_host(name):
    """At x[0] = 0.3 and 0.7 the float32 copy of a query lies across the
    jump of ``I(x[0] > 0.3)`` and ``I(np.floor(10 * x[0]))``: the columns
    come from the caller's float64 values, so float32 emulators predict
    there what the host's columns give, bit for bit."""
    formula = EXACT[name]
    q = XQ[:200].copy()
    q[:, 0] = np.where(np.arange(200) % 2, 0.3, 0.7)
    state = _fitted(formula, torch.float32).emulators[0]._mean_state
    fn = meanfun.design_matrix_fn(formula, state)
    host = meanfun.design_matrix(formula, q, state=dict(state))
    narrowed = fn(torch.as_tensor(q, dtype=torch.float32).double()).numpy()
    assert (narrowed != host).any()   # the case has teeth
    (mu, var, _), counts = _counted_predict(_fitted(formula, torch.float32), q)
    (mu_h, var_h, _), _ = _counted_predict(_host_reference(formula, torch.float32), q)
    assert counts == {"predict.dm_rows_device": len(q)}
    np.testing.assert_array_equal(mu, mu_h)
    np.testing.assert_array_equal(var, var_h)
