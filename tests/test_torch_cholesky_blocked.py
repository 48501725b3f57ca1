"""K3-K5, the blocked batched Cholesky, port against the JAX experiments.

``cholesky_blocked_plain`` (what the K3-K5 wrapper runs on a CPU tensor) is
held against ``tools/exp_chol.py``'s ``chol_blocked``, ``chol_blocked_v2``
and ``chol_blocked_v3`` in interpret mode, in float32 (they are float32
kernels); the route between K2 and the blocked kernels is pinned on both
sides of K2's bound.  The CUDA kernels themselves are compared with the
plain version on the card by ``chip_smoke.py`` (phase 2c).
"""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from mogp_tpu_torch.ops import _build  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as k2  # noqa: E402
from mogp_tpu_torch.ops import cholesky_blocked as kbl  # noqa: E402

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")

torch.set_num_threads(2)

# float32 factorizations of a matrix of condition ~10 in other summation
# orders (XLA's interpreted Pallas body against LAPACK): ~sqrt(n) eps of
# max |L|, under 4e-7 measured at n = 200
RTOL_OF_MAX = 1e-5


@pytest.fixture(scope="module")
def exp_chol():
    """``tools/exp_chol.py``, imported with ``MOGP_TPU_COMPILE_CACHE`` set,
    so that its import-time ``setdefault`` leaves no compile cache behind
    for the later test files of this process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOGP_TPU_COMPILE_CACHE", "")
        mp.syspath_prepend(TOOLS)
        return importlib.import_module("exp_chol")


def _batch_with_bad_lane():
    """(3, 200, 200) float32: X X^T / 208 + I, lane 1 replaced by -I."""
    rng = np.random.RandomState(0)
    X = rng.randn(3, 200, 208)
    A = X @ np.transpose(X, (0, 2, 1)) / 208 + np.eye(200)
    A[1] = -np.eye(200)
    return A.astype(np.float32)


@pytest.mark.parametrize("variant, jax_name", [
    ("v1", "chol_blocked"), ("v2", "chol_blocked_v2"), ("v3", "chol_blocked_v3")])
def test_plain_matches_jax_blocked_interpret(exp_chol, variant, jax_name):
    A = _batch_with_bad_lane()
    ref = np.asarray(getattr(exp_chol, jax_name)(jnp.asarray(A), chunk=2, interpret=True))
    before = dict(kbl.launches)
    got = kbl.cholesky_blocked(torch.as_tensor(A), variant)
    assert kbl.launches == before  # CPU tensors never launch
    assert got.dtype == torch.float32
    # the non-PD lane: JAX leaves its lower triangle NaN, the port the whole lane
    lower = np.tril_indices(A.shape[1])
    assert np.isnan(ref[1][lower]).all() and (np.triu(ref[1], 1) == 0).all()
    assert torch.isnan(got[1]).all()
    good = [0, 2]
    assert torch.isfinite(got[good]).all()
    assert torch.equal(torch.triu(got[good], 1), torch.zeros_like(got[good]))
    assert_allclose(got[good].numpy(), ref[good], rtol=0,
                    atol=RTOL_OF_MAX * float(np.abs(ref[good]).max()))


def test_route_pins_both_bounds():
    assert k2.BLOCKED_VARIANT in kbl.VARIANTS
    for dtype, bound in ((torch.float32, 340), (torch.float64, 240)):
        assert k2.max_shared_n(dtype) == bound
        assert k2.route(1, dtype) == "k2"
        assert k2.route(bound, dtype) == "k2"
        assert k2.route(bound + 1, dtype) == k2.BLOCKED_VARIANT
        assert k2.route(4096, dtype) == k2.BLOCKED_VARIANT
    assert k2.route(300, torch.float32) == "k2" and k2.route(300, torch.float64) != "k2"


def test_cpu_tensor_never_touches_the_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "library", refuse)
    rng = np.random.RandomState(1)
    X = rng.randn(2, 341, 341)
    A = torch.as_tensor(X @ np.transpose(X, (0, 2, 1)) + 341 * np.eye(341))
    before, k2_before = dict(kbl.launches), k2.launches
    plain = kbl.cholesky_blocked_plain(A)
    for variant in kbl.VARIANTS:
        assert torch.equal(kbl.cholesky_blocked(A, variant), plain)
    assert torch.equal(k2.cholesky_batched(A), plain)  # above K2's bound, on the CPU
    assert kbl.launches == before and k2.launches == k2_before


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_ex_reports_the_failing_column_as_cholesky_ex_does(variant):
    A = torch.eye(300, dtype=torch.float64).repeat(3, 1, 1) * 2.0
    A[1, 200, 200] = -1.0  # the pivot of column 200 fails: info 201
    A[2, 0, 0] = torch.nan
    L, info = kbl.cholesky_blocked_ex(A, variant)
    assert info.dtype == torch.int32 and info.tolist() == [0, 201, 1]
    assert torch.equal(info, torch.linalg.cholesky_ex(A)[1])
    assert torch.equal(L[0], kbl.cholesky_blocked(A, variant)[0])
    assert torch.isnan(L[1:]).all()
    empty, info0 = kbl.cholesky_blocked_ex(torch.zeros(2, 0, 0), variant)
    assert empty.shape == (2, 0, 0) and info0.tolist() == [0, 0]


def test_wrapper_checks_its_input():
    assert kbl.cholesky_blocked_plain is k2.cholesky_batched_plain
    assert kbl.cholesky_blocked(torch.zeros(3, 0, 0), "v1").shape == (3, 0, 0)
    assert kbl.cholesky_blocked(torch.zeros(0, 5, 5), "v2").shape == (0, 5, 5)
    one = kbl.cholesky_blocked(torch.tensor([[[4.0]], [[-1.0]]], dtype=torch.float64), "v3")
    assert one[0, 0, 0] == 2.0 and torch.isnan(one[1, 0, 0])
    with pytest.raises(ValueError):
        kbl.cholesky_blocked(torch.eye(3)[None], "v4")
    with pytest.raises(ValueError):
        kbl.cholesky_blocked(torch.eye(3), "v1")  # no batch axis
    with pytest.raises(ValueError):
        kbl.cholesky_blocked(torch.eye(4).expand(2, 4, 4), "v1")
    with pytest.raises(TypeError):
        kbl.cholesky_blocked(torch.eye(3, dtype=torch.float16)[None], "v1")


# ---------------------------------------------------------------------------
# A CPU rehearsal of K3's float32 arithmetic (csrc/cholesky_blocked.cu,
# blk_panel1_kernel): each panel is swept by 128 rank-1 steps over the
# diagonal block and one tile of rows below it at a time, the diagonal
# block factored again for every tile; the trailing update in three TF32
# passes.  It must meet chip_smoke.py's rule for the ill-conditioned K: its
# error against the float64 factor within 2x that of float32 cholesky_ex.

K3_ROWS = 64  # rows below the diagonal block per block of the float32 kernel
ILL_RATIO = 2.0  # chip_smoke.py's


def _fma(a, b, c):
    """``a b + c`` of float32 tensors rounded once, as ``fmaf`` rounds it
    (the product is exact in float64; the sum rounds there first, which
    differs from one rounding only at rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _k3_sweep(P, w):
    """The kernel's rank-1 sweep of the float32 panel ``P`` ``(128 + rows,
    128)``: the diagonal block's lower triangle in its first 128 rows (zero
    above), the tile's rows after.  Step k: r = rsqrt(d_k); every row i > k
    takes a_ic += -(a_ik r)(a_ck r) for c > k; then column k is scaled by
    r.  Returns ``(P, 0)``, or ``(None, k + 1)`` at a bad pivot."""
    P = P.clone()
    ids = torch.arange(P.shape[0])
    cols = torch.arange(P.shape[1])
    for k in range(w):
        cur = P[:, k].clone()
        d = cur[k]
        if not (torch.isfinite(d) and d > 0):
            return None, k + 1
        r = torch.rsqrt(d)
        v = torch.where(cols > k, cur[:P.shape[1]] * r, torch.zeros_like(r))
        act = ids > k
        P[act] = _fma(-(cur[act] * r)[:, None], v[None, :], P[act])
        P[:, k] = P[:, k] * r
    return P, 0


def _k3_cholesky(A, rows=K3_ROWS, sweep=_k3_sweep):
    """Lower factor of the float32 ``A`` ``(n, n)`` in the launch structure
    of K3 (and K5, with its ``sweep``): each panel swept over the diagonal
    block and one tile of ``rows`` rows at a time; asserts that every tile's
    copy of each diagonal block comes out the same."""
    n = A.shape[0]
    A = torch.tril(A)
    for base in range(0, n, kbl.PANEL):
        e = min(base + kbl.PANEL, n)
        w = e - base
        tiles = max(1, -(-(n - e) // rows))
        copies = []
        for t in range(tiles):
            r0 = e + t * rows
            nr = max(0, min(rows, n - r0))
            P = torch.zeros(kbl.PANEL + rows, kbl.PANEL)
            P[:w, :w] = A[base:e, base:e]
            P[kbl.PANEL:kbl.PANEL + nr, :w] = A[r0:r0 + nr, base:e]
            P, info = sweep(P, w)
            assert info == 0, "pivot {} failed".format(base + info)
            copies.append(torch.tril(P[:w, :w]))
            A[r0:r0 + nr, base:e] = P[kbl.PANEL:kbl.PANEL + nr, :w]
        assert all(torch.equal(c, copies[0]) for c in copies)
        A[base:e, base:e] = copies[0]
        if e < n:
            L21 = A[e:, base:e]
            A[e:, e:] = torch.tril(A[e:, e:] - kbl.matmul_tf32(L21, L21.T))
    return A


def test_k3_sweep_matches_the_jax_panel_step(exp_chol):
    """One panel swept as the kernel sweeps it equals ``chol_blocked`` on
    a matrix of one panel, to float32 rounding."""
    A = _batch_with_bad_lane()[0][:100, :100]
    ref = np.asarray(exp_chol.chol_blocked(jnp.asarray(A[None]), chunk=1, interpret=True))[0]
    P = torch.zeros(kbl.PANEL + K3_ROWS, kbl.PANEL)
    P[:100, :100] = torch.tril(torch.as_tensor(A))
    got, info = _k3_sweep(P, 100)
    assert info == 0
    assert_allclose(torch.tril(got[:100, :100]).numpy(), ref, rtol=0,
                    atol=RTOL_OF_MAX * float(np.abs(ref).max()))
    bad = P.clone()
    bad[40, 40] = -1.0
    assert _k3_sweep(bad, 100) == (None, 41)


def _meets_the_ill_conditioned_rule(rows, sweep):
    """:func:`_k3_cholesky` with ``sweep`` on the SqExp K of the n = 512
    large-n problem: within ``ILL_RATIO`` of float32 ``cholesky_ex``'s error
    against the float64 factor, and a backward error <= 1e-5."""
    import mogp_tpu_torch
    from mogp_tpu_torch.tools.large_n import jittered_K, make_problem

    x, y, theta = make_problem(512)
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cpu",
                                        dtype=torch.float32)
    gp.fit(theta)
    K = jittered_K(gp, theta)[0]
    truth = torch.linalg.cholesky(K.double())

    def err(L):
        return ((L.double() - truth).abs().max() / truth.abs().max()).item()

    e_ex = err(torch.linalg.cholesky_ex(K)[0])
    L = _k3_cholesky(K, rows, sweep)
    e = err(L)
    assert torch.isfinite(L).all() and e_ex > 0
    assert e <= ILL_RATIO * e_ex, (e, e_ex)
    Ld = L.double()
    assert ((Ld @ Ld.T - K.double()).abs().max() / K.abs().max()).item() <= 1e-5


def test_k3_arithmetic_meets_the_ill_conditioned_rule():
    _meets_the_ill_conditioned_rule(K3_ROWS, _k3_sweep)


# ---------------------------------------------------------------------------
# The same for K5 (blk_panel3_kernel): per 16-column micro-panel the tile's
# rank-1 factorization, its inverse by 4 Newton steps (in FMA), the
# micro-panel's rows as the product with the inverse and the rank-16 update
# of the rest of the panel, those two products in three TF32 passes.

K5_ROWS = 64  # rows below the diagonal block per block of the float32 kernel
K5_MB = 16


def _newton_inverse(L, r):
    """The kernel's 4 Newton steps X <- X (2I - L X) from X0 = diag(r):
    the first as two scalings, the others as products whose every element is
    a chain of FMAs over k ascending."""
    two = 2 * torch.eye(L.shape[0])
    X = r[:, None] * _fma(-L, r[None, :].expand_as(L), two)
    for _ in range(3):
        P = torch.zeros_like(L)
        for k in range(L.shape[0]):
            P = _fma(L[:, k:k + 1].expand_as(L), X[k:k + 1].expand_as(L), P)
        E, X0, X = two - P, X, torch.zeros_like(L)
        for k in range(L.shape[0]):
            X = _fma(X0[:, k:k + 1].expand_as(L), E[k:k + 1].expand_as(L), X)
    return X


def _k5_sweep(P, w):
    """The kernel's panel step on the float32 panel ``P`` ``(128 + rows,
    128)`` (laid out as for :func:`_k3_sweep`).  Micro-panel j0: (a) the
    tile's rank-1 sweep (column k scaled by r = rsqrt(d_k), then a_lc +=
    -L_lk L_ck by FMA) and its inverse (:func:`_newton_inverse`); (b) the
    rows below the tile times X^T; (c) the columns right of the micro-panel
    less V V^T (the diagonal block's upper triangle stays zero).  Returns
    ``(P, 0)``, or ``(None, j0 + k + 1)`` at a bad pivot."""
    P = P.clone()
    for j0 in range(0, w, K5_MB):
        mb = min(K5_MB, w - j0)
        D = torch.tril(P[j0:j0 + mb, j0:j0 + mb])
        r = torch.zeros(mb)
        for k in range(mb):
            d = D[k, k]
            if not (torch.isfinite(d) and d > 0):
                return None, j0 + k + 1
            r[k] = torch.rsqrt(d)
            D[k, k] = d * r[k]
            D[k + 1:, k] = D[k + 1:, k] * r[k]
            u = D[k + 1:, k]
            D[k + 1:, k + 1:] = torch.tril(_fma(-u[:, None], u[None, :], D[k + 1:, k + 1:]))
        P[j0:j0 + mb, j0:j0 + mb] = D
        X = _newton_inverse(D, r)
        below = slice(j0 + K5_MB, None)
        P[below, j0:j0 + mb] = kbl.matmul_tf32(P[below, j0:j0 + mb], X.T)
        if j0 + K5_MB < w:
            V = P[below, j0:j0 + mb]
            P[below, j0 + K5_MB:] -= kbl.matmul_tf32(V, V[:kbl.PANEL - j0 - K5_MB].T)
            P[:kbl.PANEL] = torch.tril(P[:kbl.PANEL])
    return P, 0


def test_k5_sweep_matches_the_jax_panel_step(exp_chol):
    """One panel worked as the kernel works it equals ``chol_blocked_v3``
    on a matrix of one panel, to float32 rounding; a bad pivot reports its
    column."""
    A = _batch_with_bad_lane()[0][:100, :100]
    ref = np.asarray(exp_chol.chol_blocked_v3(jnp.asarray(A[None]), chunk=1, interpret=True))[0]
    P = torch.zeros(kbl.PANEL + K5_ROWS, kbl.PANEL)
    P[:100, :100] = torch.tril(torch.as_tensor(A))
    got, info = _k5_sweep(P, 100)
    assert info == 0
    assert_allclose(torch.tril(got[:100, :100]).numpy(), ref, rtol=0,
                    atol=RTOL_OF_MAX * float(np.abs(ref).max()))
    bad = P.clone()
    bad[40, 40] = -1.0
    assert _k5_sweep(bad, 100) == (None, 41)


def test_k5_arithmetic_meets_the_ill_conditioned_rule():
    _meets_the_ill_conditioned_rule(K5_ROWS, _k5_sweep)
