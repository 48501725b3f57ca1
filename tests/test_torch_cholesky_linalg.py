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


def _masked(A, n_obs):
    """``m m^T * A + diag(1 - m)`` with the first ``n_obs`` rows marked."""
    m = (np.arange(A.shape[-1]) < n_obs).astype(np.float64)
    return m[:, None] * m[None, :] * A + np.diag(1.0 - m), m


@pytest.mark.parametrize("progressive", [False, True])
def test_jit_cholesky_jitter_mask(monkeypatch, progressive):
    """``jitter_mask`` per lane against mogp_tpu's ``jit_cholesky``: the
    ladder's ``mean(diag)`` over the marked rows, the jitter on them only,
    the masked pivots exactly 1; the progressive path selects per lane."""
    if progressive:
        monkeypatch.setattr(jchol, "_PROGRESSIVE_LADDER_MIN_N", 8)
        monkeypatch.setattr(tchol, "PROGRESSIVE_LADDER_MIN_N", 8)
    base = _batch(seed=5)
    lanes = [_masked(base[lane], n_obs) for lane, n_obs in enumerate([24, 17, 10, 20])]
    A = np.stack([a for a, _ in lanes])
    M = np.stack([m for _, m in lanes])
    F, jitter = tchol.jit_cholesky(_t(A), jitter_mask=_t(M))
    for lane in range(4):
        Fj, jit_j = jchol.jit_cholesky(jnp.asarray(A[lane]), jitter_mask=jnp.asarray(M[lane]))
        if lane == 2:  # the marked block is not positive definite
            assert np.isnan(np.asarray(jit_j)) and torch.isnan(jitter[lane])
            assert torch.isnan(F.L[lane]).all()
            continue
        assert_allclose(jitter[lane].item(), float(jit_j), rtol=1e-12, atol=0)
        rtol = RTOL_JITTERED if lane == 1 else RTOL
        assert_allclose(F.L[lane].numpy(), np.asarray(Fj.L), rtol=rtol, atol=ATOL)
        n_obs = int(M[lane].sum())
        L = F.L[lane].numpy()
        assert np.all(L[n_obs:, n_obs:] == np.eye(24 - n_obs)) and np.all(L[n_obs:, :n_obs] == 0)
    assert float(jitter[0]) == 0.0 and float(jitter[1]) > 0.0
    # the ladder's mean(diag) over the marked rows, divided by max(sum(m), 1)
    lad = tchol.jitter_ladder(_t(A), jitter_mask=_t(M))
    want = [np.sum(M[i] * np.diag(A[i])) / max(M[i].sum(), 1.0) for i in range(4)]
    assert_allclose(lad[:, 1].numpy(), 1e-6 * np.array(want), rtol=1e-15)
    empty = tchol.jitter_ladder(_t(A[:1]), jitter_mask=torch.zeros(1, 24, dtype=torch.float64))
    assert torch.all(empty == 0.0)


@pytest.mark.parametrize("nugget_type", ["adaptive", "fit", "fixed"])
def test_cholesky_factor_jitter_mask(nugget_type):
    """The nugget (``"fit"``, ``"fixed"``) or the jitter on ``diag(mask)``
    only, against mogp_tpu's ``cholesky_factor``."""
    rng = np.random.RandomState(6)
    lanes = [_masked(_spd(rng, 20), n_obs) for n_obs in (20, 13)]
    A = np.stack([a for a, _ in lanes])
    M = np.stack([m for _, m in lanes])
    nug = np.array([1e-3, 0.2])
    F, got = tchol.cholesky_factor(_t(A), _t(nug), nugget_type, jitter_mask=_t(M))
    for lane in range(2):
        Fj, nj = jchol.cholesky_factor(jnp.asarray(A[lane]), jnp.asarray(nug[lane]), nugget_type,
                                       jitter_mask=jnp.asarray(M[lane]))
        assert_allclose(F.L[lane].numpy(), np.asarray(Fj.L), rtol=RTOL, atol=ATOL)
        assert_allclose(got[lane].item(), float(nj), rtol=1e-15)
    assert np.all(F.L[1, 13:, 13:].numpy() == np.eye(7))
    with pytest.raises(ValueError, match="jitter_mask"):
        tchol.cholesky_factor(_t(A), _t(nug), "pivot", jitter_mask=_t(M))


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
