"""The large-n GP path end to end, port against the JAX package.

The problem of ``tests/test_blocked.py:127-150``: n = 1031, D = 4, above
the progressive jitter ladder's threshold (n >= 1024) and above both of
K2's bounds, so on the card every factorization of it runs on the blocked
K3-K5 route; here, on the CPU, on their plain version.  Both packages fit
it in float64 at the same hyperparameters.  Also: a 3-output
``MultiOutputGP`` at n = 350 (the batched 6-rung ladder above K2's bound),
the ported FLOP counters of ``utils/metrics.py`` and the helpers of
``tools/large_n.py``.
"""

import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu.utils.metrics as jmetrics  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.tools import large_n  # noqa: E402
from mogp_tpu_torch.utils import metrics as tmetrics  # noqa: E402

BENCHMARKS = os.path.join(os.path.dirname(__file__), "..", "benchmarks")

torch.set_num_threads(2)


def _problem():
    """``tests/test_blocked.py:132-136``."""
    n, d = 1031, 4
    r = np.random.RandomState(11)
    x = r.uniform(size=(n, d))
    y = np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2]
    theta = np.array([0.3, 0.1, -0.2, 0.4, 0.5])
    return x, y, theta


@pytest.fixture(scope="module")
def fitted():
    x, y, theta = _problem()
    gj = mogp_tpu.GaussianProcess(x, y, nugget="adaptive")
    gt = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cpu")
    gj.fit(theta)
    gt.fit(theta)
    return x, theta, gj, gt


def test_fit_at_n_1031_matches(fitted):
    x, theta, gj, gt = fitted
    assert gt.n >= tchol.PROGRESSIVE_LADDER_MIN_N
    assert_allclose(gt.current_logpost, float(gj.current_logpost), rtol=1e-8)
    assert_allclose(gt.nugget, float(gj.nugget), rtol=1e-8)
    assert_allclose(gt.logpost_deriv(theta), np.asarray(gj.logpost_deriv(theta)),
                    rtol=1e-6, atol=1e-8)


def test_predict_at_n_1031_matches(fitted):
    x, theta, gj, gt = fitted
    q = np.random.RandomState(12).uniform(size=(200, x.shape[1]))
    rj, rt = gj.predict(q), gt.predict(q)
    assert_allclose(rt.mean, np.asarray(rj.mean), rtol=1e-8)
    assert_allclose(rt.unc, np.asarray(rj.unc), rtol=1e-6)


def test_multi_output_gp_above_k2_bound_matches():
    n, d = 350, 3
    r = np.random.RandomState(13)
    x = r.uniform(size=(n, d))
    y = np.stack([np.sin(3 * x[:, 0]) + x[:, 1], x[:, 2] ** 2 - x[:, 0],
                  np.cos(x.sum(axis=1)) + 0.05 * r.randn(n)])
    th = np.array([[0.5, 0.2, -0.1, 0.3], [1.0, 0.4, 0.0, -0.2], [-0.3, 0.6, 0.2, 0.1]])
    q = r.uniform(size=(100, d))
    mj = mogp_tpu.MultiOutputGP(x, y, nugget="adaptive")
    mt = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    mj.fit(th)
    mt.fit(th)
    for et, ej in zip(mt.emulators, mj.emulators):
        assert_allclose(et.current_logpost, float(ej.current_logpost), rtol=1e-8)
        assert_allclose(et.nugget, float(ej.nugget), rtol=1e-8)
    # K of condition up to ~1e8 amplifies the two packages' rounding
    # orders, as in tests/test_torch_gp_slice.py
    rj, rt = mj.predict(q), mt.predict(q)
    assert_allclose(rt.mean, np.asarray(rj.mean), rtol=1e-7, atol=1e-8)
    assert_allclose(rt.unc, np.asarray(rj.unc), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("n, D", [(210, 14), (1031, 4), (4096, 8), (8192, 8)])
def test_flop_counts_match_mogp_tpu(n, D):
    assert tmetrics.flops_kernel_matrix(n, 3 * n, D) == jmetrics.flops_kernel_matrix(n, 3 * n, D)
    assert tmetrics.flops_cholesky(n) == jmetrics.flops_cholesky(n)
    for rungs in (1, 3, 6):
        assert (tmetrics.flops_gp_nlp(n, D, n_mean=2, adaptive_candidates=rungs)
                == jmetrics.flops_gp_nlp(n, D, n_mean=2, adaptive_candidates=rungs))
    assert tmetrics.flops_gp_nlp(n, D) == jmetrics.flops_gp_nlp(n, D)
    assert tmetrics.tflops_per_sec(4e12, 2.0) == jmetrics.tflops_per_sec(4e12, 2.0)
    assert tmetrics.fits_per_sec(64, 0.5) == jmetrics.fits_per_sec(64, 0.5)
    assert tmetrics.ess_per_sec([30.0, 12.0], 4.0) == jmetrics.ess_per_sec([30.0, 12.0], 4.0)


def test_timers_and_profile_trace_on_the_cpu(tmp_path):
    timers = tmetrics.PhaseTimer()
    for _ in range(2):
        with timers.phase("solve"), tmetrics.Timer() as t:
            out = torch.ones(8, 8) @ torch.ones(8, 8)
            t.sync(out, "not a tensor")
    assert t.elapsed >= 0.0 and timers.counts == {"solve": 2}
    assert "solve" in timers.report()
    with tmetrics.profile_trace(str(tmp_path)) as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert (tmp_path / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())
    assert tmetrics.get_logger().name == "mogp_tpu_torch"


def test_large_n_tool_problem_and_ladder_rungs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOGP_TPU_COMPILE_CACHE", "")  # its import-time setdefault
        mp.syspath_prepend(BENCHMARKS)
        bench = importlib.import_module("benchmark_large_n")
    for got, ref in zip(large_n.make_problem(300), bench.make_problem(300)):
        assert np.array_equal(got, ref)
    s2 = math.exp(0.5)
    assert large_n.ladder_rungs(0.0, s2, 4096) == 1
    assert large_n.ladder_rungs(1e-6 * s2, s2, 4096) == 2
    assert large_n.ladder_rungs(1e-4 * s2, s2, 8192) == 4
    assert large_n.ladder_rungs(1e-6 * s2, s2, 1000) == 6  # batched ladder below 1024


def test_cholesky_flops_run_counts_the_panels_before_the_failing_one():
    n = 1000
    full = tmetrics.flops_cholesky(n)
    assert large_n.cholesky_flops_run(n, []) == full
    assert large_n.cholesky_flops_run(n, [1, 128]) == full  # both stop in panel 0
    assert large_n.cholesky_flops_run(n, [129]) == 2 * full - tmetrics.flops_cholesky(n - 128)
    assert large_n.cholesky_flops_run(n, [n]) == 2 * full - tmetrics.flops_cholesky(n - 896)


def test_failed_rungs_of_a_progressive_fit_are_read_back():
    """A float32 fit that climbs the progressive ladder (n = 1024, short
    lengthscales): the column where each failed rung stopped is read back,
    the last rung factors, and the FLOPs that ran lie between one and
    ``rungs`` whole factorizations."""
    n = 1024
    x, y, theta = large_n.make_problem(n)
    theta[:large_n.N_DIM] = -2.0
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cpu",
                                        dtype=torch.float32)
    gp.fit(theta)
    rungs = large_n.ladder_rungs(gp.nugget, math.exp(theta[-1]), n)
    cols = large_n.failed_rung_columns(gp, theta, rungs)
    assert rungs == 4 and len(cols) == 3 and all(1 <= c <= n for c in cols)
    full = tmetrics.flops_cholesky(n)
    assert full < large_n.cholesky_flops_run(n, cols) < rungs * full
    K, C = large_n.jittered_K(gp, theta), large_n.covariance(gp, theta)
    assert torch.equal(torch.tril(K, -1), torch.tril(C, -1))
    assert_allclose(torch.diagonal(K - C, dim1=-2, dim2=-1).numpy(), gp.nugget, rtol=1e-2)
    with pytest.raises(RuntimeError):
        large_n.failed_rung_columns(gp, theta, rungs - 1)  # that ladder's last rung fails
