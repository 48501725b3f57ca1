"""A CPU rehearsal of the blocked Cholesky's float32 tensor-core arithmetic.

The route's update (``csrc/cholesky_blocked.cu``) multiplies in three TF32
passes.  ``tf32_round`` and ``matmul_tf32`` (``ops/cholesky_blocked.py``)
emulate that rounding and that product on the CPU, and a blocked
factorization in the same arithmetic (128-column panels, 32-column
micro-panels, every trailing update through the emulated product) runs on
the SqExp K of the large-n problem (``tools/large_n.py``) at n = 1024 with
the jitter the port's float32 fit realizes for it.  It must meet the rule
that ``chip_smoke.py`` holds the kernels to on the card: its error against
the float64 factor within 2x that of float32 ``cholesky_ex``.  One plain
TF32 pass must fail the same rule.
"""

import numpy as np
import pytest
import torch

import mogp_tpu_torch
from mogp_tpu_torch.ops.cholesky_blocked import matmul_tf32, tf32_round
from mogp_tpu_torch.tools.large_n import jittered_K, make_problem

torch.set_num_threads(2)

# chip_smoke.py's ILL_RATIO: a factor's error against the float64 factor may
# be at most this multiple of float32 cholesky_ex's own
ILL_RATIO = 2.0


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2**-11, one + 2**-12, -(one + 2**-11), one + 3 * 2**-11,
                      one + 2**-10 + 2**-12, 0.0, -0.0, float("inf"), 3.0e38],
                     dtype=torch.float32)
    want = torch.tensor([one + 2**-10, one, -(one + 2**-10), one + 2**-9, one + 2**-10, 0.0,
                         -0.0, float("inf"), float(tf32_round(torch.tensor([3.0e38]))[0])],
                        dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got, want)
    assert torch.isnan(tf32_round(torch.tensor([float("nan")])))[0]
    rng = np.random.RandomState(0)
    r = torch.as_tensor((rng.randn(10000) * 10.0 ** rng.randint(-20, 20, 10000)).astype(np.float32))
    t = tf32_round(r)
    assert ((t.view(torch.int32) & 0x1FFF) == 0).all()  # ten mantissa bits left
    rel = ((t.double() - r.double()).abs() / r.double().abs()).max().item()
    assert rel <= 2.0**-11
    with pytest.raises(TypeError):
        tf32_round(r.double())


def test_three_passes_are_as_accurate_as_float32():
    rng = np.random.RandomState(1)
    a = rng.randn(64, 128).astype(np.float32)
    b = rng.randn(128, 48).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)

    def err(c):
        return float(np.max(np.abs(c.numpy().astype(np.float64) - exact) / scale))

    e32, e3, e1 = err(ta @ tb), err(matmul_tf32(ta, tb)), err(matmul_tf32(ta, tb, passes=1))
    assert e3 <= 4 * max(e32, 2.0**-24)
    assert e1 >= 50 * e3
    with pytest.raises(ValueError):
        matmul_tf32(ta, tb, passes=2)


def _blocked_cholesky(A, passes, panel=128, micro=32):
    """Right-looking blocked lower Cholesky of ``A`` ``(n, n)`` float32 in
    the route's structure: each panel's diagonal block factored in
    ``micro``-column micro-panels, the rows below by a float32 triangular
    solve, each trailing update ``A22 -= L21 L21^T`` through
    ``matmul_tf32(passes)``.  A failed pivot leaves NaN."""
    A = A.clone()
    n = A.shape[-1]
    for j in range(0, n, panel):
        e = min(j + panel, n)
        D = A[j:e, j:e]
        if panel > micro:
            L11 = _blocked_cholesky(D, passes, micro, micro)
        else:
            L11, info = torch.linalg.cholesky_ex(D)
            if info != 0:
                L11 = torch.full_like(D, torch.nan)
        A[j:e, j:e] = L11
        if e < n:
            L21 = torch.linalg.solve_triangular(L11, A[e:, j:e].T, upper=False).T
            A[e:, j:e] = L21
            A[e:, e:] -= matmul_tf32(L21, L21.T, passes)
    return torch.tril(A)


@pytest.fixture(scope="module")
def large_n_K():
    """The n = 1024 SqExp K of the large-n problem, sigma^2 included, plus
    the jitter the port's float32 adaptive fit realizes for it."""
    x, y, theta = make_problem(1024)
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cpu",
                                        dtype=torch.float32)
    gp.fit(theta)
    return jittered_K(gp, theta)[0]


def test_3xtf32_blocked_cholesky_meets_the_ill_conditioned_rule(large_n_K):
    K = large_n_K
    truth = torch.linalg.cholesky(K.double())

    def err(L):
        if not torch.isfinite(L).all():
            return float("inf")
        return ((L.double() - truth).abs().max() / truth.abs().max()).item()

    e_ex = err(torch.linalg.cholesky_ex(K)[0])
    e3 = err(_blocked_cholesky(K, passes=3))
    e1 = err(_blocked_cholesky(K, passes=1))
    assert np.isfinite(e_ex) and e_ex > 0
    assert e3 <= ILL_RATIO * e_ex, (e3, e_ex)
    assert e1 > ILL_RATIO * e_ex, (e1, e_ex)  # one TF32 pass breaks the rule
    L3 = _blocked_cholesky(K, passes=3).double()
    backward = ((L3 @ L3.T - K.double()).abs().max() / K.abs().max()).item()
    assert backward <= 1e-5  # chip_smoke.py's CHOL_TOL["float32"]
