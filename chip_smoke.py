#!/usr/bin/env python3
"""Bring-up check of mogp_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. The card's name and power limit (``nvidia-smi``), and the build of the
   CUDA kernels from ``mogp_tpu_torch/csrc`` (``nvcc``, at first use).
2. Every kernel against its plain PyTorch version on the card, at the
   bring-up shapes and at the shapes the main path gives it, in float32
   and float64, then timed against the plain version: K1, the fused
   kernel-matrix build (2); K2, the batched Cholesky (2b), up to its
   shared-memory bound (n = 340 in float32, 240 in float64), every call
   launching K2 once; K3-K5, the blocked Cholesky variants v1-v3 (2c), above
   that bound up to n = 8192 (the large-n fit's (1, 4096) and (1, 8192),
   its MAP fit's (4, 4096) lanes, its float64 fit's (1, 4096)), with a
   non-PD lane and a lane whose pivot fails mid-matrix (its ``info`` the
   failing column), and on the ill-conditioned SqExp K of the n = 4096
   problem at its realized jitter; every call one panel loop.
3. The serving path at full width: a 64-output ``MultiOutputGP`` with
   n = 210 training points in D = 14 dimensions (``nugget="adaptive"``,
   float32 on the card) fit at seeded hyperparameters, then asked for
   means and variances at 10^6 seeded query points.  The first 4096
   queries are held against the same problem run by the port on the CPU in
   float64.
4. The MAP fit at full width, with the protocol of ``bench.py:107-128``:
   ``fit_GP_MAP`` of the same 64 outputs, 15 restarts each, ``maxiter=50``
   (race on, one-rung trajectory ladder), float32 on the card; a warm-up
   fit from seed 0, then the timed refit from seed 1.  All 64 outputs must
   fit; the winners of the first 4 outputs, re-evaluated in float64, must
   be within 0.25 nats on average of the same seeded fit run by the port
   on the CPU in float64.
5. The large-n GP (``benchmarks/benchmark_large_n.py``, ``bench.py``'s
   ``large_n`` metric): one ``GaussianProcess`` (D = 8,
   ``nugget="adaptive"``, float32), through ``tools/large_n.py`` at n =
   4096 and 8192 (fit time, TFLOP/s, one value + gradient, one route
   launch per progressive ladder rung), ``fit_GP_MAP`` with 4 restarts and
   ``maxiter=20``, and a prediction at 10^5 seeded queries.  The float32 log
   posterior must be within 1e-3 of the port's on the CPU in float64 at the
   card's realized nugget, and the same fit in float64 on the card within
   1e-9 of the CPU's.  No CUDA tensor may reach ``torch.linalg.cholesky_ex``
   in this phase.

Around each of phases 3, 4 and 5 the kernels' launch counters are zeroed
just before and read just after; every kernel of the path must have
launched (K1 in 3, K2 in 4, the routed blocked variant in 5).  The
blocked variants the route does not take are checked and timed in 2c and
listed with the launches they made in 5 (none) and ``"routed": false``.
The last three lines of standard output are a JSON object describing each
kernel, the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits with a non-zero code and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

N_POINTS, N_DIM, N_OUTPUTS, N_QUERIES = 210, 14, 64, 10**6
N_CHECK = 4096

# phase 2: kernel vs plain version on the same inputs.  float32: the
# kernel's difference form and the plain matmul form round differently
# (as tests/test_pallas.py:25 allows the Pallas kernel); float64: a few
# ulps of |z|^2.
KERNEL_TOL = {"float32": (2e-5, 2e-6), "float64": (1e-12, 1e-13)}

# phase 3: float32 on the card vs float64 on the CPU, on the first 4096
# queries.  Sized from the reference: mogp_tpu on a CPU, same problem,
# float32 vs float64, differs by at most 5.6e-5 in the means (targets of
# order 1-4), 4.1e-6 in the variances and 2.7e-6 (relative) in the log
# posteriors.  The limits are ten times that.
SLICE_TOL = {"mean": 5.6e-4, "unc": 4.1e-5, "logpost_rel": 2.7e-5}

# phase 2b: max |L - L_plain| / max |L_plain| on B B^T + n I (condition
# ~5).  Both are float Cholesky factorizations in other summation orders:
# ~sqrt(n) eps of |L|, about 2e-6 in float32 at n = 1000 (9.1e-7 measured
# at n = 340 on an H100); the limits leave ten times that.
CHOL_TOL = {"float32": 1e-5, "float64": 1e-12}

# phase 4: the MAP fit (bench.py:107-128) and its quality gate, the mean
# NLP gap of the JAX package's own test (tests/test_fitting.py:144-146)
N_TRIES, MAXITER, N_QUALITY, NLP_GAP = 15, 50, 4, 0.25


def make_data(n_outputs, seed=1234):
    """Synthetic tsunami-shaped data (the generator of bench.py:67-77)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    w = rng.randn(n_outputs, N_DIM)
    phase = rng.uniform(0, 2 * np.pi, size=n_outputs)
    targets = (
        np.sin(inputs @ w.T + phase)
        + 0.3 * (inputs**2) @ np.abs(w).T
        + 0.01 * rng.randn(N_POINTS, n_outputs)
    )
    return inputs, targets.T.copy()


def make_thetas(seed=0):
    """Raw hyperparameters: correlation raws in U(-1, 1), covariance raw in
    U(-0.5, 0.5)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(-1, 1, size=(N_OUTPUTS, N_DIM)),
         rng.uniform(-0.5, 0.5, size=(N_OUTPUTS, 1))],
        axis=1,
    )


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(shape, dtype, seed):
    import torch

    L, n, m, D = shape
    g = torch.Generator().manual_seed(seed)

    def u(*size):
        return torch.rand(*size, generator=g, dtype=torch.float64)

    return (
        u(L, n, D).to("cuda", dtype),
        u(m, D).to("cuda", dtype),
        torch.exp(2.0 * u(L, D) - 1.0).to("cuda", dtype),
        torch.exp(u(L) - 0.5).to("cuda", dtype),
    )


def phase_kernels(km, main_shape):
    """Kernel vs plain version, checked and timed; returns the kernel's
    record for the JSON line, without ``launches``."""
    import torch

    shapes = [(1, 50, 37, 3), (1, 130, 200, 14), (1, 5, 5, 1),
              (N_OUTPUTS, N_POINTS, 4096, N_DIM), main_shape]
    main_err = main_rel = 0.0
    for dtype in (torch.float32, torch.float64):
        rtol, atol = KERNEL_TOL[str(dtype).replace("torch.", "")]
        for seed, shape in enumerate(shapes):
            for base in ("sqexp", "mat52"):
                args = kernel_inputs(shape, dtype, seed)
                K = km.kernel_matrix(*args, base=base)
                torch.cuda.synchronize()
                P = km.kernel_matrix_plain(*args, base=base)
                err = (K - P).abs()
                max_abs = err.max().item()
                max_rel = (err / P.abs().clamp_min(torch.finfo(dtype).tiny)).max().item()
                ok = bool((err <= atol + rtol * P.abs()).all())
                print("phase 2: kernel_matrix {} {} {} max_abs_err {} max_rel_err {} "
                      "(rtol {}, atol {}) {}".format(
                          str(dtype)[6:], base, shape, max_abs, max_rel, rtol, atol,
                          "ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError("kernel_matrix disagrees with its plain version")
                if shape == main_shape and dtype == torch.float32 and base == "sqexp":
                    main_err, main_rel = max_abs, max_rel
                del K, P, err, args
        # Matern 5/2 is exactly 1 where r2 == 0
        x1, _, _, _ = kernel_inputs((1, 20, 20, 4), dtype, 99)
        one = torch.ones(1, dtype=dtype, device="cuda")
        K = km.kernel_matrix(x1, x1[0].contiguous(), torch.ones(1, 4, dtype=dtype, device="cuda"),
                             one, base="mat52")
        if not torch.equal(torch.diagonal(K[0]), torch.ones(20, dtype=dtype, device="cuda")):
            raise AssertionError("Matern 5/2 diagonal is not exactly 1")
        print("phase 2: kernel_matrix {} mat52 diagonal exactly 1: ok".format(str(dtype)[6:]))

    timings = {}
    for dtype in (torch.float32, torch.float64):
        for shape in (main_shape, (N_OUTPUTS, N_POINTS, 4096, N_DIM),
                      (N_OUTPUTS, N_POINTS, 32768, N_DIM)):
            args = kernel_inputs(shape, dtype, 7)

            def kern():
                return km.kernel_matrix(*args, base="sqexp")

            def plain():
                return km.kernel_matrix_plain(*args, base="sqexp")

            # plain, kernel, kernel, plain on one card
            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            out_bytes = shape[0] * shape[1] * shape[2] * (4 if dtype == torch.float32 else 8)
            print("phase 2: time sqexp {} {}: kernel {} ms ({} {}), plain {} ms ({} {}); "
                  "kernel writes {} GB/s".format(
                      str(dtype)[6:], shape, ms, k1, k2, plain_ms, p1, p2,
                      out_bytes / (ms * 1e-3) / 1e9))
            timings[(str(dtype)[6:], shape)] = (ms, plain_ms)
            del args
            torch.cuda.empty_cache()
    ms, plain_ms = timings[("float32", main_shape)]
    record = {
        "name": "kernel_matrix",
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/kernel_matrix.cu",
        "replaces": "mogp_tpu/ops/pallas_kernels.py:88",
        "max_abs_err": main_err,
        "max_rel_err": main_rel,
        "ms": ms,
        "plain_ms": plain_ms,
    }
    return record


def _rel_err(L, P):
    return ((L - P).abs().max() / P.abs().max()).item()


def spd_batch(B, n, dtype, seed):
    """``X X^T + n I`` with X standard normal from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, n, generator=g, dtype=torch.float64, device="cuda")
    A = X @ X.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64, device="cuda")
    return A.to(dtype)


def _launch_once(kb, A):
    """``cholesky_batched(A)``, checking that it launched K2 once."""
    import torch

    if kb.route(A.shape[-1], A.dtype) != "k2":
        raise AssertionError("phase 2b shape above K2's bound")
    before = kb.launches
    L = kb.cholesky_batched(A)
    torch.cuda.synchronize()
    if kb.launches != before + 1:
        raise AssertionError("cholesky_batched did not launch its kernel once")
    return L


def _check_bad_lane(kb, A, label):
    """Lane 1 of ``A`` is ``-I``: it must come out all NaN, the others
    finite and within the limit of their plain factors."""
    import torch

    tol = CHOL_TOL[str(A.dtype)[6:]]
    L = _launch_once(kb, A)
    P = kb.cholesky_batched_plain(A)
    good = [i for i in range(A.shape[0]) if i != 1]
    err = _rel_err(L[good], P[good])
    ok = (bool(torch.isnan(L[1]).all()) and bool(torch.isnan(P[1]).all())
          and bool(torch.isfinite(L[good]).all()) and err <= tol)
    print("phase 2b: cholesky_batched {} {} with lane 1 = -I: lane 1 all NaN {}, "
          "others finite {}, rel err {} (limit {}) {}".format(
              str(A.dtype)[6:], label, bool(torch.isnan(L[1]).all()),
              bool(torch.isfinite(L[good]).all()), err, tol, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("cholesky_batched fails the non-PD lane check")


def phase_cholesky(kb):
    """K2 against its plain version, checked and timed, up to its bound
    ``max_shared_n`` (larger n are phase 2c's); returns the kernel's record
    for the JSON line, without ``launches``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(5)  # the input of tests/test_pallas.py:34-55
    A = rng.randn(4, 40, 40)
    A = A @ np.transpose(A, (0, 2, 1)) + 40 * np.eye(40)
    A[1] = -np.eye(40)
    main = (960, N_POINTS)
    main_err = main_rel = 0.0
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        tol = CHOL_TOL[name]
        bound = kb.max_shared_n(dtype)
        _check_bad_lane(kb, torch.as_tensor(A, dtype=dtype, device="cuda"), "(4, 40, 40)")
        shapes = [main, (384, N_POINTS), (N_OUTPUTS, 15), (16, 1), (8, bound)]
        for seed, (B, n) in enumerate(shapes):
            A_ = spd_batch(B, n, dtype, seed)
            L = _launch_once(kb, A_)
            P = kb.cholesky_batched_plain(A_)
            err = _rel_err(L, P)
            upper0 = bool((torch.triu(L, 1) == 0).all())
            ok = err <= tol and upper0 and bool(torch.isfinite(L).all())
            print("phase 2b: cholesky_batched {} ({}, {}, {}): rel err {} (limit {}), "
                  "max abs err {}, upper triangle zero {} {}".format(
                      name, B, n, n, err, tol, (L - P).abs().max().item(), upper0,
                      "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("cholesky_batched disagrees with its plain version")
            if (B, n) == main and dtype == torch.float32:
                main_err, main_rel = (L - P).abs().max().item(), err
            del A_, L, P

    timings = {}
    for dtype in (torch.float32, torch.float64):
        for B, n in (main, (384, N_POINTS)):
            A_ = spd_batch(B, n, dtype, 7)

            def kern():
                return kb.cholesky_batched(A_)

            def plain():
                return kb.cholesky_batched_plain(A_)

            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            flops = B * n**3 / 3
            print("phase 2b: time cholesky_batched {} ({}, {}, {}): kernel {} ms ({} {}), "
                  "plain {} ms ({} {}); kernel {} GFLOP/s, {} us per matrix".format(
                      str(dtype)[6:], B, n, n, ms, k1, k2, plain_ms, p1, p2,
                      flops / (ms * 1e-3) / 1e9, ms * 1e3 / B))
            timings[(str(dtype)[6:], B, n)] = (ms, plain_ms)
            del A_
            torch.cuda.empty_cache()
    ms, plain_ms = timings[("float32",) + main]
    return {
        "name": "cholesky_batched",
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/cholesky_batched.cu",
        "replaces": "tools/pallas_cholesky_experiment.py:124",
        "max_abs_err": main_err,
        "max_rel_err": main_rel,
        "ms": ms,
        "plain_ms": plain_ms,
    }


# phase 2c: K3-K5 (tools/exp_chol.py) against cholesky_blocked_plain
BLOCKED_REPLACES = {"v1": "tools/exp_chol.py:111", "v2": "tools/exp_chol.py:269",
                    "v3": "tools/exp_chol.py:411"}
BLOCKED_SHAPES = [((64, 341), "float32"), ((4, 241), "float64"), ((15, 1000), "float32"),
                  ((15, 1000), "float64"), ((1, 4096), "float32"), ((1, 8192), "float32"),
                  ((384, 341), "float32"), ((4, 4096), "float32"), ((1, 4096), "float64")]
BLOCKED_MAIN = ((1, 4096), "float32")  # the factorization of the large-n slice, phase 5
# the ill-conditioned K: a variant's error against the float64 factor may
# be at most this multiple of cholesky_ex's own
ILL_RATIO = 2.0

# phase 5: the large-n GP (benchmarks/benchmark_large_n.py, bench.py:300-365)
LARGE_N, LARGER_N, MAP_TRIES, MAP_MAXITER, LARGE_N_QUERIES = 4096, 8192, 4, 20, 10**5
# float32 on the card against float64 on the CPU at the card's realized
# nugget, and float64 on the card against float64 on the CPU
LARGE_N_TOL = {"float32": 1e-3, "float64": 1e-9}


def _blocked_once(kbl, A, variant):
    """``cholesky_blocked_ex(A, variant)``, checking that it ran one panel
    loop; returns ``(L, info)``."""
    import torch

    before = dict(kbl.launches)
    L, info = kbl.cholesky_blocked_ex(A, variant)
    torch.cuda.synchronize()
    after = dict(kbl.launches)
    before[variant] += 1
    if after != before:
        raise AssertionError("cholesky_blocked did not count one launch of {}".format(variant))
    return L, info


def _check_blocked(kbl, A, variant, label, bad=None):
    """Variant against the plain version on ``A``: the lanes of ``bad``
    (lane -> the 1-based column of its failing pivot) all NaN with that
    ``info``, the others finite with ``info`` 0, upper triangle exactly
    zero, within ``CHOL_TOL``.  Returns (rel err, max abs err)."""
    import torch

    bad = bad or {}
    dtype = str(A.dtype)[6:]
    tol = CHOL_TOL[dtype]
    L, info = _blocked_once(kbl, A, variant)
    P = kbl.cholesky_blocked_plain(A)
    good = [i for i in range(A.shape[0]) if i not in bad]
    err = _rel_err(L[good], P[good])
    abs_err = (L[good] - P[good]).abs().max().item()
    nan_ok = all(bool(torch.isnan(L[i]).all()) for i in bad)
    want = [bad.get(i, 0) for i in range(A.shape[0])]
    info_ok = info.tolist() == want
    upper0 = bool((torch.triu(L[good], 1) == 0).all())
    ok = (nan_ok and info_ok and upper0 and bool(torch.isfinite(L[good]).all())
          and bool(torch.isfinite(P[good]).all()) and err <= tol)
    print("phase 2c: cholesky_blocked {} {} {}: rel err {} (limit {}), max abs err {}, upper "
          "triangle zero {}{}, info as expected {} {}".format(
              variant, dtype, label, err, tol, abs_err, upper0,
              ", lanes {} all NaN {} (info {})".format(
                  sorted(bad), nan_ok, [info[i].item() for i in sorted(bad)]) if bad else "",
              info_ok, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("cholesky_blocked {} disagrees with its plain version".format(variant))
    return err, abs_err


def _check_blocked_ill(kbl, K, variant, label):
    """Variant against the float64 factor of the same float32 matrix ``K``,
    whose condition (~1e7) leaves no two float32 factorizations within
    ``CHOL_TOL`` of each other: its error must be within ``ILL_RATIO`` of
    ``cholesky_ex``'s own, and its backward error max |L L^T - K| / max |K|
    within ``CHOL_TOL``."""
    import torch

    L, _ = _blocked_once(kbl, K, variant)
    P = kbl.cholesky_blocked_plain(K)
    truth = kbl.cholesky_blocked_plain(K.double())
    err, err_plain = _rel_err(L.double(), truth), _rel_err(P.double(), truth)
    Ld = L.double()
    back = ((Ld @ Ld.transpose(-1, -2) - K.double()).abs().max() / K.abs().max()).item()
    tol = CHOL_TOL["float32"]
    ok = (bool(torch.isfinite(L).all()) and bool(torch.isfinite(truth).all())
          and err <= max(ILL_RATIO * err_plain, tol) and back <= tol)
    print("phase 2c: cholesky_blocked {} float32 {}: rel err against the float64 factor {} "
          "(cholesky_ex's {}, limit {}x that), vs cholesky_ex {}, backward error {} (limit {}) "
          "{}".format(variant, label, err, err_plain, ILL_RATIO, _rel_err(L, P), back, tol,
                      "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("cholesky_blocked {} loses accuracy on an ill-conditioned "
                             "K".format(variant))


def large_n_K(n):
    """The SquaredExponential K (sigma^2 included) of the n-point large-n
    problem at its raw theta, on the card in float32, with the jitter that
    the port's fit on the card realizes for it; returns ``(K + jitter I,
    jitter)``."""
    import mogp_tpu_torch
    from mogp_tpu_torch.tools.large_n import jittered_K, make_problem

    x, y, theta = make_problem(n)
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cuda")
    gp.fit(theta)
    return jittered_K(gp, theta), gp.nugget


def phase_blocked(kbl):
    """K3-K5 against their plain version, checked and timed against
    ``cholesky_ex``; returns one record per variant for the JSON line,
    without ``launches``."""
    import torch

    errs = {}
    for seed, ((B, n), dtype_name) in enumerate(BLOCKED_SHAPES):
        dtype = getattr(torch, dtype_name)
        A = spd_batch(B, n, dtype, 50 + seed)
        bad = {}
        if B >= 4:  # where the batch has room: a non-PD lane, and a lane
            # whose pivot fails two thirds of the way down
            A[1] = -torch.eye(n, dtype=dtype, device="cuda")
            c = n - n // 3
            A[3, c, c] = -A[3, c, c]
            bad = {1: 1, 3: c + 1}
        for variant in kbl.VARIANTS:
            errs[(variant, (B, n), dtype_name)] = _check_blocked(
                kbl, A, variant, "({}, {}, {})".format(B, n, n), bad)
        del A
        torch.cuda.empty_cache()
    K, jitter = large_n_K(LARGE_N)
    for variant in kbl.VARIANTS:
        _check_blocked_ill(kbl, K, variant, "(1, {0}, {0}) SqExp K of the large-n problem + its "
                           "realized jitter {1}".format(LARGE_N, jitter))
    del K

    timings = {}
    for (B, n), dtype_name in BLOCKED_SHAPES:
        dtype = getattr(torch, dtype_name)
        A = spd_batch(B, n, dtype, 7)
        reps, warmup = (3, 1) if n >= LARGER_N else (10, 2) if n >= LARGE_N else (20, 3)

        def timer(variant):
            if variant == "plain":
                return time_ms(lambda: kbl.cholesky_blocked_plain(A), reps, warmup)
            return time_ms(lambda: kbl.cholesky_blocked(A, variant), reps, warmup)

        order = ["plain", *kbl.VARIANTS, *reversed(kbl.VARIANTS), "plain"]
        got = {}
        for v in order:
            got.setdefault(v, []).append(timer(v))
        ms = {v: sum(t) / len(t) for v, t in got.items()}
        flops = B * n**3 / 3
        print("phase 2c: time ({}, {}, {}) {}: plain (cholesky_ex) {} ms {}; {}".format(
            B, n, n, dtype_name, ms["plain"], got["plain"], "; ".join(
                "{} {} ms {} = {} GFLOP/s".format(v, ms[v], got[v], flops / (ms[v] * 1e-3) / 1e9)
                for v in kbl.VARIANTS)))
        timings[((B, n), dtype_name)] = ms
        del A
        torch.cuda.empty_cache()
    main = timings[BLOCKED_MAIN]
    fastest = min(kbl.VARIANTS, key=lambda v: main[v])
    print("phase 2c: fastest variant at {} {}: {}".format(*BLOCKED_MAIN, fastest))
    return [{
        "name": "cholesky_blocked_" + v,
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/cholesky_blocked.cu",
        "replaces": BLOCKED_REPLACES[v],
        "max_abs_err": errs[(v,) + BLOCKED_MAIN][1],
        "max_rel_err": errs[(v,) + BLOCKED_MAIN][0],
        "ms": main[v],
        "plain_ms": main["plain"],
    } for v in kbl.VARIANTS]


class forbid_cholesky_ex_on_cuda:
    """Within the block, ``torch.linalg.cholesky_ex`` / ``cholesky`` raise on
    a CUDA tensor: the path must factor with the port's kernels."""

    def __enter__(self):
        import torch

        self.saved = torch.linalg.cholesky_ex, torch.linalg.cholesky

        def guard(fn):
            def wrapped(A, *args, **kwargs):
                if A.is_cuda:
                    raise AssertionError("a CUDA tensor reached torch.linalg." + fn.__name__)
                return fn(A, *args, **kwargs)
            return wrapped

        torch.linalg.cholesky_ex, torch.linalg.cholesky = (guard(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        import torch

        torch.linalg.cholesky_ex, torch.linalg.cholesky = self.saved
        return False


def _route_launches(kbl, variant, fn):
    """Run ``fn()`` and return the launches of ``variant`` it made."""
    before = kbl.launches[variant]
    fn()
    return kbl.launches[variant] - before


def phase_large_n(mogp_tpu_torch, km, kb, kbl, label):
    """The large-n GP slice (module doc, phase 5); returns the routed
    blocked variant and the launches of each blocked variant in it."""
    import numpy as np
    import torch
    from mogp_tpu_torch.tools import large_n

    route = kb.route(LARGE_N, torch.float32)
    if route != kb.route(LARGER_N, torch.float32) or route not in kbl.VARIANTS:
        raise AssertionError("the large-n sizes are not routed to one blocked variant")
    torch.cuda.synchronize()
    km.launches = kb.launches = 0
    for v in kbl.VARIANTS:
        kbl.launches[v] = 0
    with forbid_cholesky_ex_on_cuda():
        x, y, theta = large_n.make_problem(LARGE_N)
        rows = {}
        for n, oracle in ((LARGE_N, True), (LARGER_N, False)):
            row, g = large_n.measure(n, iters=3, oracle=oracle)
            rows[n] = row
            per_fit = _route_launches(kbl, route, lambda g=g: g.fit(theta))
            print("phase 5: " + large_n.format_row(row) + "; {} launches of {} per fit ({} "
                  "rungs) on {}".format(per_fit, route, row["rungs"], label))
            if (per_fit != row["rungs"] or not np.isfinite(row["nlp"])
                    or not row["valgrad_finite"]):
                raise AssertionError("the large-n fit at n={} did not run one {} launch per "
                                     "rung, or is not finite".format(n, route))
            del g
            torch.cuda.empty_cache()

        # the MAP fit, seeded with numpy, 4 restarts as lanes
        gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cuda")
        np.random.seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mogp_tpu_torch.fit_GP_MAP(gp, n_tries=MAP_TRIES, maxiter=MAP_MAXITER)
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        print("phase 5: fit_GP_MAP n={}, {} restarts, maxiter={}: {} s, winner NLP {}, nugget {}, "
              "theta {}".format(LARGE_N, MAP_TRIES, MAP_MAXITER, map_s, gp.current_logpost,
                                gp.nugget, gp.theta.get_data().tolist()))
        if not np.isfinite(gp.current_logpost):
            raise AssertionError("the large-n MAP fit did not converge to a finite NLP")

        q = np.random.RandomState(2).uniform(size=(LARGE_N_QUERIES, large_n.N_DIM))
        k1_before = km.launches
        t0 = time.perf_counter()
        res = gp.predict(q)  # host arrays: the device work is done
        predict_s = time.perf_counter() - t0
        print("phase 5: predict {} points at n={}: {} s = {} points/s; K1 launches {}".format(
            LARGE_N_QUERIES, LARGE_N, predict_s, LARGE_N_QUERIES / predict_s,
            km.launches - k1_before))
        if not (res.mean.shape == (LARGE_N_QUERIES,) and np.isfinite(res.mean).all()
                and np.isfinite(res.unc).all() and (res.unc >= 0).all()):
            raise AssertionError("the large-n prediction is not finite, or has a negative "
                                 "variance")
        if km.launches == k1_before:
            raise AssertionError("the large-n prediction did not launch K1")

        # float32 on the card against float64 on the CPU at the card's
        # nugget (the tool's oracle); float64 on the card against float64
        # on the CPU, both adaptive
        row = rows[LARGE_N]
        t0 = time.perf_counter()
        g64 = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cuda",
                                             dtype=torch.float64)
        g64.fit(theta)
        lp64, nugget64 = large_n.cpu_logpost(x, y, theta)
        rel64 = abs(g64.current_logpost - lp64) / abs(lp64)
        ok = (row["nlp_rel_err"] <= LARGE_N_TOL["float32"] and rel64 <= LARGE_N_TOL["float64"]
              and math.isclose(g64.nugget, nugget64, rel_tol=LARGE_N_TOL["float64"]))
        print("phase 5: n={} logpost: float32 card {} vs float64 CPU at nugget {} fixed {}: rel "
              "{} (limit {}); float64 card {} (nugget {}) vs float64 CPU {} (nugget {}): rel {} "
              "(limit {}); float64 fits took {} s {}".format(
                  LARGE_N, row["nlp"], row["nugget"], row["nlp_cpu64"], row["nlp_rel_err"],
                  LARGE_N_TOL["float32"], g64.current_logpost, g64.nugget, lp64, nugget64, rel64,
                  LARGE_N_TOL["float64"], time.perf_counter() - t0, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("the large-n log posterior disagrees with the float64 CPU")
    torch.cuda.synchronize()
    launches = dict(kbl.launches)
    print("phase 5: launches K1 {}, K2 {}, blocked {} (the route: {})".format(
        km.launches, kb.launches, launches, route))
    if launches[route] == 0:
        raise AssertionError("the routed blocked variant did not launch in phase 5")
    return route, launches


def phase_slice(mogp_tpu_torch, km, kb, label):
    import numpy as np
    import torch

    x, y = make_data(N_OUTPUTS)
    thetas = make_thetas()
    q = np.random.RandomState(1).uniform(size=(N_QUERIES, N_DIM))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.launches = kb.launches = 0
    t0 = time.perf_counter()
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    t1 = time.perf_counter()
    mgp.fit(thetas)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = mgp.predict(q)  # returns host arrays: the device work is done
    t3 = time.perf_counter()
    launches, chol_launches = km.launches, kb.launches

    if res.mean.shape != (N_OUTPUTS, N_QUERIES) or res.unc.shape != (N_OUTPUTS, N_QUERIES):
        raise AssertionError("prediction has the wrong shape")
    if not np.isfinite(res.mean).all():
        raise AssertionError("non-finite predictive means")
    if not (np.isfinite(res.unc).all() and (res.unc >= 0).all()):
        raise AssertionError("predictive variances not finite and >= 0")
    if launches <= 0 or chol_launches <= 0:
        raise AssertionError("the serving path did not launch kernel_matrix and cholesky_batched")
    peak = torch.cuda.max_memory_allocated()
    construct_s, fit_s, predict_s = t1 - t0, t2 - t1, t3 - t2
    print("phase 3: MultiOutputGP {} outputs, n={}, D={}, float32 on {}: construct {} s, "
          "fit {} s, predict {} points {} s = {} points/s ({} output-points/s); "
          "kernel_matrix launches {}, cholesky_batched launches {}; peak device memory {} "
          "GB".format(
              N_OUTPUTS, N_POINTS, N_DIM, label, construct_s, fit_s, N_QUERIES, predict_s,
              N_QUERIES / predict_s, N_OUTPUTS * N_QUERIES / predict_s, launches,
              chol_launches, peak / 1e9))

    # the same fit and predict again, warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgp.fit(thetas)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res2 = mgp.predict(q)
    t2 = time.perf_counter()
    print("phase 3: warm repeat on {}: fit {} s, predict {} s = {} points/s; "
          "identical results: {}".format(
              label, t1 - t0, t2 - t1, N_QUERIES / (t2 - t1),
              bool(np.array_equal(res.mean, res2.mean) and np.array_equal(res.unc, res2.unc))))
    del res2

    # reference: the port on the CPU in float64, first 4096 queries
    t0 = time.perf_counter()
    ref = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    ref.fit(thetas)
    rr = ref.predict(q[:N_CHECK])
    ref_s = time.perf_counter() - t0
    d_mean = float(np.max(np.abs(res.mean[:, :N_CHECK] - rr.mean)))
    d_unc = float(np.max(np.abs(res.unc[:, :N_CHECK] - rr.unc)))
    lp_gpu = np.array([em.current_logpost for em in mgp.emulators])
    lp_cpu = np.array([em.current_logpost for em in ref.emulators])
    d_lp = float(np.max(np.abs(lp_gpu - lp_cpu) / np.abs(lp_cpu)))
    nug_gpu = np.array([em.nugget for em in mgp.emulators])
    nug_cpu = np.array([em.nugget for em in ref.emulators])
    ok = (d_mean <= SLICE_TOL["mean"] and d_unc <= SLICE_TOL["unc"]
          and d_lp <= SLICE_TOL["logpost_rel"])
    print("phase 3: float32 {} vs float64 CPU on {} queries: max |d mean| {} (limit {}), "
          "max |d var| {} (limit {}), max rel d logpost {} (limit {}); jittered outputs "
          "{} vs {}; CPU reference took {} s: {}".format(
              label, N_CHECK, d_mean, SLICE_TOL["mean"], d_unc, SLICE_TOL["unc"], d_lp,
              SLICE_TOL["logpost_rel"], int((nug_gpu > 0).sum()), int((nug_cpu > 0).sum()),
              ref_s, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's predictions disagree with the float64 reference")
    return launches


def phase_fit(mogp_tpu_torch, km, kb, label):
    """The MAP fit at full width (bench.py:107-128); returns K2's launches."""
    import numpy as np
    import torch
    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.utils.metrics import fits_per_sec

    x, y = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    np.random.seed(0)
    t0 = time.perf_counter()
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=MAXITER)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    km.launches = kb.launches = 0
    np.random.seed(1)
    t0 = time.perf_counter()
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=MAXITER)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, km_launches = kb.launches, km.launches
    peak = torch.cuda.max_memory_allocated()
    n_fit = len(mgp.get_indices_fit())
    phases = {}
    for k, v in fitting.last_phase_times:
        phases[k] = phases.get(k, 0.0) + v
    print("phase 4: fit_GP_MAP {} outputs x {} restarts, n={}, D={}, maxiter={}, float32 on {}: "
          "warm-up fit {} s; timed fit {} s = mogp_tsunami_fits_per_sec {}; phases {}; "
          "outputs fit {}; cholesky_batched launches {} (kernel_matrix {}); peak device "
          "memory {} GB".format(
              N_OUTPUTS, N_TRIES, N_POINTS, N_DIM, MAXITER, label, warm_s, fit_s,
              fits_per_sec(n_fit, fit_s), phases, n_fit, launches, km_launches, peak / 1e9))
    if n_fit != N_OUTPUTS:
        raise AssertionError("only {} of {} outputs were fit".format(n_fit, N_OUTPUTS))
    if launches <= 0:
        raise AssertionError("the MAP fit did not launch cholesky_batched")

    # quality: the same seeded fit of the first outputs in float64 on the
    # CPU; the card's winners re-evaluated in float64 by gp_fit
    t0 = time.perf_counter()
    ref = mogp_tpu_torch.MultiOutputGP(x, y[:N_QUALITY], nugget="adaptive", device="cpu")
    np.random.seed(1)
    mogp_tpu_torch.fit_GP_MAP(ref, n_tries=N_TRIES, refit=True, maxiter=MAXITER)
    cpu_s = time.perf_counter() - t0
    card = mogp_tpu_torch.MultiOutputGP(x, y[:N_QUALITY], nugget="adaptive", device="cpu")
    card.fit([em.theta.get_data() for em in mgp.emulators[:N_QUALITY]])
    nlp_card = np.array([em.current_logpost for em in card.emulators])
    nlp_cpu = np.array([em.current_logpost for em in ref.emulators])
    gap = float(np.mean(nlp_card - nlp_cpu))
    ok = bool(np.isfinite(nlp_card).all()) and gap <= NLP_GAP
    print("phase 4: quality on the first {} outputs: card winners in float64 NLP {}, float64 "
          "CPU fit NLP {} (took {} s); float32 NLP on the card {}; mean gap {} (limit {}) "
          "{}".format(N_QUALITY, nlp_card.tolist(), nlp_cpu.tolist(), cpu_s,
                      [em.current_logpost for em in mgp.emulators[:N_QUALITY]], gap, NLP_GAP,
                      "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's MAP fit is worse than the float64 reference")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mogp_tpu_torch
    from mogp_tpu_torch.models.gp import _predict_tile_size
    from mogp_tpu_torch.ops import _build
    from mogp_tpu_torch.ops import cholesky_batched as kb
    from mogp_tpu_torch.ops import cholesky_blocked as kbl
    from mogp_tpu_torch.ops import kernel_matrix as km

    if os.path.dirname(os.path.dirname(os.path.abspath(mogp_tpu_torch.__file__))) != here:
        raise RuntimeError("mogp_tpu_torch was not imported from this checkout")

    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [line.split(":", 1)[1].strip() for line in _build.build_log.splitlines()
            if "registers" in line]
    print("phase 1: {} ({}); kernel library ready in {} s (nvcc {} s); ptxas: {}".format(
        torch.cuda.get_device_name(0), smi, build_s, _build.build_seconds, regs))

    # the query tile the main path gives the kernel (0: one untiled call)
    tile = _predict_tile_size(N_QUERIES, None, n_train=N_POINTS, n_lanes=N_OUTPUTS) or N_QUERIES
    main_shape = (N_OUTPUTS, N_POINTS, tile, N_DIM)
    record = phase_kernels(km, main_shape)
    chol_record = phase_cholesky(kb)
    blocked_records = phase_blocked(kbl)
    record["launches"] = phase_slice(mogp_tpu_torch, km, kb, smi)
    chol_record["launches"] = phase_fit(mogp_tpu_torch, km, kb, smi)
    route, blocked_launches = phase_large_n(mogp_tpu_torch, km, kb, kbl, smi)
    for rec, v in zip(blocked_records, kbl.VARIANTS):
        rec["launches"] = blocked_launches[v]
        rec["routed"] = v == route

    print(json.dumps({"kernels": [record, chol_record, *blocked_records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
