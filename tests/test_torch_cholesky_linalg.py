"""The port's factorizations and marginal-likelihood algebra against the JAX package.

Each lane of a batched port call is held against one unbatched
``mogp_tpu.ops`` call on the same matrix.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu.ops.cholesky as jchol  # noqa: E402
from mogp_tpu.ops import linalg as jlin  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import linalg as tlin  # noqa: E402

torch.set_num_threads(2)

# Well-conditioned float64 factors: LAPACK (torch) and XLA's Cholesky differ
# only in rounding order.
RTOL, ATOL = 1e-10, 1e-12
# A lane that needed jitter is factored at condition ~1e6-1e8, which
# amplifies the same rounding-order differences by that much.
RTOL_JITTERED = 1e-7


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _spd(rng, n, shift=1.0):
    B = rng.randn(n, n)
    return B @ B.T / n + shift * np.eye(n)


def _needs_jitter(rng, n):
    """PSD rank-5 matrix pushed 1e-8 * mean(diag) below PSD: the exact
    factorization fails, the 1e-6 rung succeeds."""
    V = rng.randn(n, 5)
    A = V @ V.T
    return A - 1e-8 * np.mean(np.diag(A)) * np.eye(n)


def _batch(n=24, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([_spd(rng, n), _needs_jitter(rng, n), -np.eye(n), _spd(rng, n, 0.1)])


def _check_ladder(A, L, jitter):
    for lane in range(A.shape[0]):
        Fj, jit_j = jchol.jit_cholesky(jnp.asarray(A[lane]))
        if lane == 2:  # not positive definite: every rung fails
            assert np.isnan(np.asarray(jit_j)) and torch.isnan(jitter[lane])
            assert np.isnan(np.asarray(Fj.L)).all() and torch.isnan(L[lane]).all()
            continue
        assert_allclose(jitter[lane].item(), float(jit_j), rtol=1e-12, atol=0)
        rtol = RTOL_JITTERED if lane == 1 else RTOL
        assert_allclose(L[lane].numpy(), np.asarray(Fj.L), rtol=rtol, atol=ATOL)
    assert float(jitter[0]) == 0.0 and float(jitter[1]) > 0.0


def test_jit_cholesky_batched_ladder():
    A = _batch()
    F, jitter = tchol.jit_cholesky(_t(A), progressive_ok=False)
    _check_ladder(A, F.L, jitter)
    # lanes do not contaminate each other: each lane alone gives the same
    for lane in range(A.shape[0]):
        F1, j1 = tchol.jit_cholesky(_t(A[lane:lane + 1]), progressive_ok=False)
        assert torch.equal(F1.L[0].nan_to_num(7.0), F.L[lane].nan_to_num(7.0))
        assert torch.equal(j1[0].nan_to_num(7.0), jitter[lane].nan_to_num(7.0))


def test_jit_cholesky_progressive(monkeypatch):
    monkeypatch.setattr(jchol, "_PROGRESSIVE_LADDER_MIN_N", 8)
    monkeypatch.setattr(tchol, "PROGRESSIVE_LADDER_MIN_N", 8)
    A = _batch(seed=1)
    F, jitter = tchol.jit_cholesky(_t(A))
    _check_ladder(A, F.L, jitter)
    Fb, jb = tchol.jit_cholesky(_t(A), progressive_ok=False)
    assert torch.equal(F.L.nan_to_num(7.0), Fb.L.nan_to_num(7.0))
    assert torch.equal(jitter.nan_to_num(7.0), jb.nan_to_num(7.0))


@pytest.mark.parametrize("nugget_type", ["adaptive", "fit", "fixed"])
def test_cholesky_factor(nugget_type):
    rng = np.random.RandomState(2)
    A = np.stack([_spd(rng, 20), _spd(rng, 20, 0.5)])
    nug = np.array([1e-3, 0.2])
    F, got_nug = tchol.cholesky_factor(_t(A), _t(nug), nugget_type)
    for lane in range(2):
        Fj, nj = jchol.cholesky_factor(jnp.asarray(A[lane]), jnp.asarray(nug[lane]), nugget_type)
        assert_allclose(F.L[lane].numpy(), np.asarray(Fj.L), rtol=RTOL, atol=ATOL)
        assert_allclose(got_nug[lane].item(), float(nj), rtol=1e-15)


def test_pivot_is_not_ported():
    """``"pivot"`` once raised ``NotImplementedError`` here, and the test
    keeps the name it had then, so that its history stays one line; it
    now checks that ``cholesky_factor`` dispatches ``"pivot"`` to the
    pivoted factor, per lane, as mogp_tpu's does
    (tests/test_torch_pivot.py holds the factor itself)."""
    rng = np.random.RandomState(8)
    A = np.stack([_spd(rng, 6), np.ones((6, 6))])
    F, nug = tchol.cholesky_factor(_t(A), _t([0.0, 0.0]), "pivot")
    assert isinstance(F, tchol.PivotedChoFactor)
    assert F.rank.tolist() == [6, 1]
    for lane in range(2):
        Fj, nj = jchol.cholesky_factor(jnp.asarray(A[lane]), 0.0, "pivot")
        assert_allclose(float(F.logdet()[lane]), float(Fj.logdet()), rtol=1e-12)
        assert F.P[lane].tolist()[:int(Fj.rank)] == np.asarray(Fj.P).tolist()[:int(Fj.rank)]
        assert float(nug[lane]) == float(nj) == 0.0


@pytest.mark.parametrize("M", [0, 2])
def test_marginal_core_and_nlp(M):
    rng = np.random.RandomState(3)
    L, n = 3, 25
    K = np.stack([_spd(rng, n) for _ in range(L)])
    dm = rng.randn(L, n, M)
    resid = rng.randn(L, n)
    if M:
        B = np.stack([_spd(rng, M) for _ in range(L)])
        mic = np.linalg.inv(B)
        logdet_B = np.linalg.slogdet(B)[1]
    else:
        mic, logdet_B = np.zeros((L, 0, 0)), np.zeros(L)
    n_coeff = np.full(L, float(n))

    Kinv = tchol.ChoFactor(tchol.fixed_cholesky(_t(K)))
    core = tlin.marginal_core(Kinv, _t(dm), _t(resid), _t(mic))
    nlp = tlin.marginal_nlp(core, Kinv, _t(logdet_B), _t(n_coeff))
    assert nlp.shape == (L,)
    for lane in range(L):
        Kj = jchol.ChoFactor(jchol.fixed_cholesky(jnp.asarray(K[lane])))
        cj = jlin.marginal_core(Kj, jnp.asarray(dm[lane]), jnp.asarray(resid[lane]),
                                jnp.asarray(mic[lane]))
        for name in ("W", "Wh", "alpha", "H_Kinv_t"):
            assert_allclose(getattr(core, name)[lane].numpy(), np.asarray(getattr(cj, name)),
                            rtol=RTOL, atol=ATOL, err_msg=name)
        assert_allclose(core.Ainv.L[lane].numpy(), np.asarray(cj.Ainv.L), rtol=RTOL, atol=ATOL)
        ref = jlin.marginal_nlp(cj, Kj, logdet_B[lane], n_coeff[lane])
        assert_allclose(nlp[lane].item(), float(ref), rtol=RTOL, atol=ATOL)
