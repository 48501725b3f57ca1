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
