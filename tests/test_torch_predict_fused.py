"""The fused prediction (K1 redesigned), port against the JAX package.

``predict_fused_plain`` (what the wrapper runs on a CPU tensor) is held
against ``mogp_tpu``'s ``_gp_predict_impl`` lane by lane; the route and the
tile rule are checked as pure functions; and a float32 mirror of the CUDA
kernel's blocked forward substitution (panels of 16 rows: a diagonal solve
per column by the pivots' reciprocals, then the trailing update one panel
column at a time) is held to the float64 solve.  The CUDA kernel itself is compared
with the plain version on the card by ``chip_smoke.py`` (phase 2d).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.models import gp as jgp  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402

torch.set_num_threads(2)

# as tests/test_torch_gp_slice.py: float64 on both sides, same algorithm,
# LAPACK and XLA round in other orders and the jittered long-lengthscale
# lane's K (condition ~1e8) amplifies that to ~1e-9 of each quantity's
# scale; ATOL is relative to the largest reference value
RTOL, ATOL = 1e-7, 1e-8

L, N, D, Q = 3, 40, 3, 301
KERNELS = {"sqexp": "SquaredExponential", "mat52": "Matern52"}
MEANS = {0: None, 4: "x[0] + x[1] + x[2]"}


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert_allclose(got, ref, rtol=RTOL, atol=ATOL * scale)


def _problem(lanes, base, M):
    """``lanes`` GPs on one design, fit in both packages at seeded
    hyperparameters; the last lane has long lengthscales: with SqExp its
    exact factorization fails and the adaptive nugget takes a jitter rung;
    Matern 5/2 factors there without one, and from theta = -4 down the two
    packages' float64 solves part by more than RTOL, so its long lane is
    theta = -2."""
    rng = np.random.RandomState(11)
    x = rng.rand(N, D)
    ys = [np.sin(3.0 * x[:, 0]) + x[:, 1], x[:, 2] ** 2 - x[:, 0],
          np.cos(x.sum(axis=1)) + 0.1 * rng.randn(N)][-lanes:]
    q = rng.rand(Q, D)
    js, ts = [], []
    for k, y in enumerate(ys):
        gj = mogp_tpu.GaussianProcess(x, y, mean=MEANS[M], kernel=KERNELS[base])
        gt = mogp_tpu_torch.GaussianProcess(x, y, mean=MEANS[M], kernel=KERNELS[base],
                                            device="cpu")
        th = np.concatenate([rng.uniform(0.5, 2.5, size=D), rng.uniform(-0.5, 0.5, size=1)])
        if k == len(ys) - 1:
            th[:D] = -8.0 if base == "sqexp" else -2.0
        gj.fit(th)
        gt.fit(th)
        js.append(gj)
        ts.append(gt)
    assert ts[-1].nugget > 0.0 or base == "mat52"
    return q, js, ts


@pytest.mark.parametrize("lanes", [1, L])
@pytest.mark.parametrize("M", [0, 4])
@pytest.mark.parametrize("base", ["sqexp", "mat52"])
def test_plain_matches_jax_predict(base, M, lanes):
    q, js, ts = _problem(lanes, base, M)
    arts = tgp.cat_lanes([g._artifacts for g in ts])
    data = tgp.cat_lanes([g._data for g in ts])
    kern = ts[0].kernel
    dm = ts[0].get_design_matrix(q)
    assert dm.shape == (Q, M) and tgp._predict_route(data, kern) == "fused"
    n_corr = kern.get_n_params(data.inputs)
    sigma2 = torch.exp(arts.raw[:, n_corr])
    for unc in (True, False):
        for include_nugget in (True, False):
            var_shift = sigma2 + arts.nugget if include_nugget else sigma2
            mu, var = pf.predict_fused(
                *kern.lane_inputs(data.inputs, torch.as_tensor(q), arts.raw[:, :n_corr], sigma2),
                arts.Kinv.L, arts.Kinv_t_mean, arts.Kinv_dm, torch.as_tensor(dm), arts.mean,
                arts.Ainv.L, var_shift, unc=unc, base=base,
            )
            # the slice's own entry point takes the same route
            mu2, var2 = tgp.gp_predict(arts, data, torch.as_tensor(q), torch.as_tensor(dm),
                                       kern, "adaptive", unc=unc, include_nugget=include_nugget)
            assert torch.equal(mu, mu2) and (var is None) == (var2 is None) == (not unc)
            for lane, gj in enumerate(js):
                mj, vj = jgp._gp_predict_impl(gj._artifacts, gj._data, q, dm, gj.kernel,
                                              gj.nugget_type, unc=unc,
                                              include_nugget=include_nugget)
                _close(mu[lane].numpy(), mj)
                if unc:
                    assert torch.equal(var[lane], var2[lane])
                    _close(var[lane].numpy(), vj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_route_is_a_function_of_shape(dtype):
    nf, mf = pf.N_FUSED[dtype], pf.M_FUSED
    for device in ("cpu", "cuda"):
        assert pf.route(device, 210, 0, "stationary", False, dtype) == "fused"
        assert pf.route(device, 1, 0, "uniform", False, dtype) == "fused"
        assert pf.route(device, nf, mf, "stationary", False, dtype) == "fused"
        assert pf.route(device, nf + 1, 0, "stationary", False, dtype) == "unfused"
        assert pf.route(device, 210, mf + 1, "stationary", False, dtype) == "unfused"
        assert pf.route(device, 210, 0, "stationary", True, dtype) == "unfused"
        assert pf.route(device, 210, 0, "product", False, dtype) == "unfused"
        assert pf.route(device, 0, 0, "stationary", False, dtype) == "unfused"
        assert pf.route(device, 4096, 0, "stationary", False, dtype) == "unfused"
    assert pf.route("cpu", 210, 0, "stationary", False, torch.float16) == "unfused"
    with pytest.raises(ValueError):
        pf.route("meta", 210, 0, "stationary", False, dtype)
    # the bounds come from one block's shared memory
    assert pf.shared_bytes(nf, mf, dtype) <= pf.MAX_SHARED_BYTES
    assert pf.N_FUSED[torch.float32] >= 210 and pf.N_FUSED[torch.float64] >= 210


def test_shared_bytes_matches_the_kernel_layout():
    """``csrc/kernel_matrix.cu::fused_smem_elems`` at the headline shape:
    the 210 x 64 tile, three 210 x 16 strips, max(M, 1) + 9 rows of 64."""
    assert pf.shared_bytes(210, 0, torch.float32) == 4 * (210 * 64 + 3 * 210 * 16 + 10 * 64)
    assert pf.shared_bytes(210, 15, torch.float64) == 8 * (210 * 64 + 3 * 210 * 16 + 24 * 64)
    # below 35 rows the build's staging is the larger part of the region
    assert pf.shared_bytes(8, 0, torch.float32) == 4 * (8 * 64 + (8 * 16 + 64 * 17) + 10 * 64)
    # the headline emulator leaves room for two blocks on an SM
    assert 2 * pf.shared_bytes(210, 0, torch.float32) <= pf.MAX_SHARED_BYTES


def test_only_fused_shapes_take_the_fused_wrapper(monkeypatch):
    calls = []
    real = pf.predict_fused_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pf, "predict_fused_plain", counting)
    rng = np.random.RandomState(3)
    x, q = rng.rand(20, 2), rng.rand(30, 2)
    for kernel, full_cov, fused in (("SquaredExponential", False, True),
                                    ("UniformMat52", False, True),
                                    ("SquaredExponential", True, False),
                                    ("ProductMat52", False, False)):
        g = mogp_tpu_torch.GaussianProcess(x, x[:, 0], kernel=kernel, device="cpu")
        g.fit(np.zeros(g.n_params))
        del calls[:]
        res = g.predict(q, full_cov=full_cov)
        assert len(calls) == int(fused)
        assert np.isfinite(res.mean).all() and np.isfinite(res.unc).all()


def test_fused_tile_rule():
    """On the fused route no (L, n, tile) buffer exists: 10^6 queries at 64
    lanes take a few tiles, split evenly, not the unfused rule's 206."""
    m = 10**6
    tile = tgp._predict_tile_size(m, None, n_train=210, n_lanes=64, fused=True, n_dim=14)
    n_tiles = -(-m // tile)
    assert tile % 256 == 0 and 1 <= n_tiles <= 4
    assert n_tiles * tile - m < 256 * n_tiles  # the padded last tile is short
    old = tgp._predict_tile_size(m, None, n_train=210, n_lanes=64)
    assert -(-m // old) == 206
    # below the cap: one untiled call; an explicit size is kept as before
    assert tgp._predict_tile_size(4096, None, n_train=210, n_lanes=64, fused=True) == 0
    assert tgp._predict_tile_size(m, 2000, n_train=210, n_lanes=64, fused=True) == 2048
    # on the CPU the unfused rule holds: the plain version builds K*
    x = np.random.RandomState(0).rand(30, 3)
    g = mogp_tpu_torch.GaussianProcess(x, x[:, 0], device="cpu")
    assert tgp._query_tile(m, None, g._data, g.kernel) == tgp._predict_tile_size(
        m, None, n_train=30)


def _blocked_forward_f32(Lk, K, panel=16):
    """The kernel's substitution order in float32: per panel, each column's
    diagonal solve with the pivots' correctly rounded reciprocals, then
    V[below] -= Lk[below, k] V[k] for the panel's columns k in order."""
    Lk, V = Lk.astype(np.float32), K.astype(np.float32).copy()
    n = Lk.shape[0]
    for p0 in range(0, n, panel):
        p1 = min(p0 + panel, n)
        for k in range(p0, p1):
            V[k] = V[k] * (np.float32(1) / Lk[k, k])
            V[k + 1:p1] -= Lk[k + 1:p1, k, None] * V[k]
        for k in range(p0, p1):
            V[p1:] -= Lk[p1:, k, None] * V[k]
    return V


@pytest.mark.parametrize("base", ["sqexp", "mat52"])
def test_blocked_substitution_order_in_float32(base):
    """Phase 2d's rule: in float32 against the float64 solve, the kernel's
    order may err at most 2x what the library's float32 solve errs, on the
    headline shape (n = 210, D = 14, a tile of 64 queries) with
    long-lengthscale lanes whose K needs the jitter."""
    from mogp_tpu_torch.ops.kernel_matrix import kernel_matrix_plain
    from mogp_tpu_torch.ops.kernels import _BASE_FNS, squared_distance

    rng = np.random.RandomState(4)
    n, Dh, q = 210, 14, 64
    x1, x2 = rng.rand(1, n, Dh), rng.rand(q, Dh)
    for log_scale in (0.0, -3.0):
        et = torch.full((1, Dh), np.exp(log_scale), dtype=torch.float64)
        s2 = torch.ones(1, dtype=torch.float64)
        x1t = torch.as_tensor(x1)
        Kf = _BASE_FNS[base](squared_distance(x1t, x1t, et))[0]
        Kf = Kf + 1e-6 * torch.eye(n, dtype=torch.float64)
        Lk = torch.linalg.cholesky(Kf).numpy()
        Ks = kernel_matrix_plain(x1t, torch.as_tensor(x2), et, s2, base)[0].numpy()
        ref = np.linalg.solve(Lk, Ks)
        lib = torch.linalg.solve_triangular(torch.as_tensor(Lk, dtype=torch.float32),
                                            torch.as_tensor(Ks, dtype=torch.float32),
                                            upper=False).numpy()
        mine = _blocked_forward_f32(Lk, Ks)
        for got_v, got_l in ((mine, lib), ((mine**2).sum(0), (lib**2).sum(0))):
            want = ref if got_v.ndim == 2 else (ref**2).sum(0)
            err_mine = np.max(np.abs(got_v - want))
            err_lib = np.max(np.abs(got_l - want))
            assert np.isfinite(err_mine) and err_mine <= 2.0 * err_lib, (err_mine, err_lib)


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as the card's FFMA (the product
    is exact in float64; the sum is rounded twice, which differs from once
    only at rare ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _mean_stage_f32(W, V, dm, LA):
    """The kernel's mean-term stage in float32: ``P = W^T V`` (``W`` the
    vectors ``[alpha | Kinv_dm]``, ``V`` the n x 64 tile of K*) as four row
    slices, slice ``s`` two FMA chains in row order (rows ``s + 8 k`` and
    ``s + 4 + 8 k``) summed, the slices summed ``(s0 + s1) + (s2 + s3)``; ``r = dm^T - P[1:]``; ``u = LA^-1 r`` column
    by column, dividing by the pivots, and ``|u|^2`` one FMA chain.  Returns
    ``(k . alpha, r, |u|^2)``."""
    W, V = W.astype(np.float32), V.astype(np.float32)
    parts = []
    for s in range(4):
        chains = []
        for i0 in (s, s + 4):
            acc = np.zeros((W.shape[1], V.shape[1]), np.float32)
            for i in range(i0, V.shape[0], 8):
                acc = _fma32(W[i, :, None], V[i, None, :], acc)
            chains.append(acc)
        parts.append(chains[0] + chains[1])
    P = (parts[0] + parts[1]) + (parts[2] + parts[3])
    r = dm.T.astype(np.float32) - P[1:]
    LA = LA.astype(np.float32)
    x, u2 = r.copy(), np.zeros(V.shape[1], np.float32)
    for a in range(LA.shape[0]):
        u = x[a] / LA[a, a]
        u2 = _fma32(u, u, u2)
        x[a + 1:] = _fma32(-LA[a + 1:, a, None], u[None, :], x[a + 1:])
    return P[0], r, u2


@pytest.mark.parametrize("M", [1, 15, 16, 32])
def test_mean_stage_order_in_float32(M):
    """Phase 2d's rule for the mean-term stage: in float32 against float64,
    the kernel's order (``_mean_stage_f32``; 16 vectors a chunk, so M = 15,
    16 and 32 take one, two and three chunks) may err at most 2x what
    torch's float32 ``Kinv_dm^T @ K*`` and ``solve_triangular`` err, at the
    universal-kriging shape: n = 210, D = 14, Matern 5/2, lanes with long
    lengthscales at the jitter rung, a mean (the intercept, the inputs,
    then their squares) that explains most of y, and A with the prior
    N(0, 1) on the coefficients."""
    from mogp_tpu_torch.ops.kernel_matrix import kernel_matrix_plain
    from mogp_tpu_torch.ops.kernels import _BASE_FNS, squared_distance

    rng = np.random.RandomState(25)
    n, Dh, q = 210, 14, 64
    x1, x2 = rng.rand(1, n, Dh), rng.rand(q, Dh)

    def design(x):
        return np.concatenate([np.ones_like(x[:, :1]), x, x**2, x**3], axis=1)[:, :M]

    H, dm = design(x1[0]), design(x2)
    for log_scale in (0.0, -3.0):
        et = torch.full((1, Dh), np.exp(log_scale), dtype=torch.float64)
        s2 = torch.ones(1, dtype=torch.float64)
        x1t = torch.as_tensor(x1)
        K = (_BASE_FNS["mat52"](squared_distance(x1t, x1t, et))[0]
             + 1e-6 * torch.eye(n, dtype=torch.float64)).numpy()
        Ks = kernel_matrix_plain(x1t, torch.as_tensor(x2), et, s2, "mat52")[0].numpy()
        y = H @ rng.randn(M) + 0.05 * rng.randn(n)
        Kinv_dm, Kinv_y = np.linalg.solve(K, H), np.linalg.solve(K, y)
        A = H.T @ Kinv_dm + np.eye(M)
        LA = np.linalg.cholesky(A)
        alpha = Kinv_y - Kinv_dm @ np.linalg.solve(A, H.T @ Kinv_y)
        ref_r = dm.T - Kinv_dm.T @ Ks
        ref = (Ks.T @ alpha, ref_r, (np.linalg.solve(LA, ref_r) ** 2).sum(0))
        t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
        lib_r = t32(dm).T - t32(Kinv_dm).T @ t32(Ks)
        lib_u = torch.linalg.solve_triangular(t32(LA), lib_r, upper=False)
        lib = (t32(Ks).T @ t32(alpha), lib_r, (lib_u**2).sum(0))
        mine = _mean_stage_f32(np.concatenate([alpha[:, None], Kinv_dm], axis=1), Ks, dm, LA)
        for name, got, want, got_l in zip(("k . alpha", "r", "|u|^2"), mine, ref, lib):
            err_mine = np.max(np.abs(got - want))
            err_lib = np.max(np.abs(got_l.numpy() - want))
            assert np.isfinite(err_mine) and err_mine <= 2.0 * err_lib, (name, err_mine, err_lib)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = lambda *s: torch.zeros(*s, dtype=torch.float64)  # noqa: E731
    Lk = torch.eye(5, dtype=torch.float64)[None].repeat(2, 1, 1)
    good = [t(2, 5, 3), t(4, 3), t(2, 3), t(2), Lk, t(2, 5), t(2, 5, 0), t(4, 0), t(2, 0),
            t(2, 0, 0), t(2)]
    mu, var = pf.predict_fused(*good)
    assert mu.shape == var.shape == (2, 4) and torch.all(var == 0)
    before = pf.launches
    assert pf.predict_fused(*good, unc=False)[1] is None
    assert pf.launches == before  # CUDA launches only
    bad = list(good)
    bad[4] = Lk[:, :, :4].contiguous()
    with pytest.raises(ValueError):
        pf.predict_fused(*bad)
    bad = list(good)
    bad[0] = good[0].float()
    with pytest.raises(TypeError):
        pf.predict_fused(*bad)
    bad = list(good)
    bad[1] = t(3, 4).T
    with pytest.raises(ValueError):
        pf.predict_fused(*bad)
    with pytest.raises(ValueError):
        pf.predict_fused(*good, base="rbf")
