"""K2 and the differentiable factorizations of the port against the JAX package.

``cholesky_batched_plain`` (what the K2 wrapper runs on a CPU tensor) is
held against the Pallas ``cholesky_batched`` in interpret mode, as
``tests/test_pallas.py`` runs it; the Cholesky ``autograd.Function``s
against ``jax.vjp``; the three jitter ladders against ``mogp_tpu``'s.  The
CUDA kernel itself is compared with the plain version on the card by
``chip_smoke.py``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu.ops.cholesky as jchol  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as k2  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from pallas_cholesky_experiment import cholesky_batched as pallas_cholesky_batched  # noqa: E402

torch.set_num_threads(2)

# float64, well-conditioned factors (condition < 1e3): LAPACK, XLA and the
# Pallas body round in different orders, nothing more
RTOL, ATOL = 1e-10, 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _spd(rng, n, shift=1.0):
    B = rng.randn(n, n)
    return B @ B.T / n + shift * np.eye(n)


def _pallas_input():
    """The input of ``tests/test_pallas.py:34-55``, in float64."""
    rng = np.random.RandomState(5)
    A = rng.randn(4, 40, 40)
    return A @ np.transpose(A, (0, 2, 1)) + 40 * np.eye(40)


def test_plain_matches_pallas_interpret_with_a_bad_lane():
    A = _pallas_input()
    A[1] = -np.eye(40)
    ref = np.asarray(pallas_cholesky_batched(jnp.asarray(A), interpret=True))
    before = k2.launches
    got = k2.cholesky_batched(_t(A))
    assert k2.launches == before  # CPU tensors never launch
    assert torch.isnan(got[1]).all()  # the whole lane, upper triangle included
    assert np.isnan(ref[1]).any()
    good = [0, 2, 3]
    assert torch.isfinite(got[good]).all()
    assert_allclose(got[good].numpy(), ref[good], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[good], k2.cholesky_batched_plain(_t(A))[good])
    assert torch.equal(torch.triu(got[good], 1), torch.zeros_like(got[good]))


def test_wrapper_shapes_and_bounds():
    assert k2.max_shared_n(torch.float32) == 340
    assert k2.max_shared_n(torch.float64) == 240
    for n, item in ((340, 4), (240, 8)):
        assert n * (n + 1) // 2 * item <= k2.MAX_SHARED_BYTES < (n + 1) * (n + 2) // 2 * item
    empty = k2.cholesky_batched(torch.zeros(3, 0, 0, dtype=torch.float64))
    assert empty.shape == (3, 0, 0)
    assert k2.cholesky_batched(torch.zeros(0, 5, 5)).shape == (0, 5, 5)
    one = k2.cholesky_batched(_t([[[4.0]], [[0.0]]]))
    assert one[0, 0, 0] == 2.0 and torch.isnan(one[1, 0, 0])
    with pytest.raises(ValueError):
        k2.cholesky_batched(torch.eye(3, dtype=torch.float64))  # no batch axis
    with pytest.raises(ValueError):
        k2.cholesky_batched(torch.zeros(2, 3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        k2.cholesky_batched(torch.eye(4, dtype=torch.float64).expand(2, 4, 4))
    with pytest.raises(TypeError):
        k2.cholesky_batched(torch.eye(3, dtype=torch.float16)[None])


def test_cholesky_function_backward_matches_jax_vjp():
    rng = np.random.RandomState(0)
    A = np.stack([_spd(rng, 7), _spd(rng, 7, 0.3), _spd(rng, 7, 2.0)])
    L_bar = rng.randn(3, 7, 7)
    At = _t(A).requires_grad_(True)
    L = tchol.fixed_cholesky(At)
    (got,) = torch.autograd.grad(L, At, _t(L_bar))
    for lane in range(3):
        Lj, vjp = jax.vjp(jnp.linalg.cholesky, jnp.asarray(A[lane]))
        assert_allclose(L[lane].detach().numpy(), np.asarray(Lj), rtol=RTOL, atol=ATOL)
        (ref,) = vjp(jnp.asarray(L_bar[lane]))
        assert_allclose(got[lane].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_cholesky_function_differentiates_twice():
    rng = np.random.RandomState(1)
    A = _t(np.stack([_spd(rng, 4), _spd(rng, 4, 0.5)])).requires_grad_(True)

    def f(a):  # symmetric use of the input, as K is built
        return tchol.fixed_cholesky(0.5 * (a + a.transpose(-1, -2)))

    assert torch.autograd.gradcheck(f, (A,))
    assert torch.autograd.gradgradcheck(f, (A,))


def test_chol_of_sum_matches_jax():
    rng = np.random.RandomState(2)
    M = np.stack([_spd(rng, 6), _spd(rng, 6, 0.2)])
    L_pre = np.linalg.cholesky(M)
    L_bar = rng.randn(2, 6, 6)
    Mt, Lp = _t(M).requires_grad_(True), _t(L_pre)
    out = tchol._chol_of_sum(Mt, Lp)
    assert torch.equal(out, Lp) and out.data_ptr() != Lp.data_ptr()
    (got,) = torch.autograd.grad(out, Mt, _t(L_bar))
    for lane in range(2):
        _, vjp = jax.vjp(jchol._chol_of_sum, jnp.asarray(M[lane]), jnp.asarray(L_pre[lane]))
        ref, _ = vjp(jnp.asarray(L_bar[lane]))
        assert_allclose(got[lane].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _ladder_batch(n=16, seed=3):
    """Lanes: well conditioned; smallest eigenvalue -5e-7 * mean(diag), so
    the exact factorization fails and 1e-6 * mean(diag) succeeds;
    not positive definite at any rung; well conditioned with a small shift."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    eigs = np.linspace(1.0, 2.0, n)
    eigs[0] = 0.0
    shifted = Q @ np.diag(eigs) @ Q.T
    shifted -= 5e-7 * np.mean(np.diag(shifted)) * np.eye(n)
    return np.stack([_spd(rng, n), shifted, -np.eye(n), _spd(rng, n, 0.1)])


@pytest.mark.parametrize("ladder", [False, True, "single"])
@pytest.mark.parametrize("reuse_factor", [True, False])
def test_ladders_select_the_jax_jitter(ladder, reuse_factor):
    A = _ladder_batch()
    F, jitter = tchol.jit_cholesky(_t(A), reuse_factor=reuse_factor, sparse_ladder=ladder,
                                   progressive_ok=False)
    for lane in range(A.shape[0]):
        Fj, jit_j = jchol.jit_cholesky(jnp.asarray(A[lane]), reuse_factor=reuse_factor,
                                       sparse_ladder=ladder)
        if lane == 2:  # not positive definite at any rung
            assert np.isnan(float(jit_j)) and torch.isnan(jitter[lane])
            assert torch.isnan(F.L[lane]).all()
            continue
        assert_allclose(jitter[lane].item(), float(jit_j), rtol=1e-15, atol=0)
        assert_allclose(F.L[lane].numpy(), np.asarray(Fj.L), rtol=1e-7 if lane == 1 else RTOL,
                        atol=ATOL)
    assert (float(jitter[0]) == 0.0) is (ladder != "single")
    assert float(jitter[1]) > 0.0


def test_jitter_carries_no_gradient():
    """The jitter is picked on a detached copy: the factor's gradient is
    that of chol(A + jitter I) with the jitter a constant, as JAX's
    ``lax.stop_gradient`` makes it."""
    A = _ladder_batch()[[0, 1, 3]]
    W = np.random.RandomState(4).randn(*A.shape)
    At = _t(A).requires_grad_(True)
    F, jitter = tchol.jit_cholesky(At, progressive_ok=False)
    assert not jitter.requires_grad
    assert float(jitter[1]) > 0.0
    (got,) = torch.autograd.grad((F.L * _t(W)).sum(), At)
    for lane in range(3):
        def f(a, w=jnp.asarray(W[lane])):
            return jnp.sum(jchol.jit_cholesky(a)[0].L * w)

        ref = np.asarray(jax.grad(f)(jnp.asarray(A[lane])))
        # the jittered lane is factored at condition ~1e6
        assert_allclose(got[lane].numpy(), ref, rtol=1e-7 if lane == 1 else RTOL,
                        atol=1e-7 * np.abs(ref).max())


def test_replay_counts_the_launches_recorded_in_a_graph():
    """A CUDA graph into which K2 was recorded n times launches it n times
    a replay: ``replay`` replays the graph and adds n to ``launches``."""
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    before = k2.launches
    k2.replay(Graph(), 3)
    k2.replay(Graph(), 3)
    assert Graph.replays == 2 and k2.launches == before + 6
