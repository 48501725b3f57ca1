#!/usr/bin/env python3
"""Bring-up check of mogp_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. The card's name and power limit (``nvidia-smi``), and the build of the
   CUDA kernels from ``mogp_tpu_torch/csrc`` (``nvcc``, at first use).
2. Every kernel against its plain PyTorch version on the card, at the
   bring-up shapes and at the shapes the main path gives it, in float32
   and float64, then timed against the plain version.
3. The serving path at full width: a 64-output ``MultiOutputGP`` with
   n = 210 training points in D = 14 dimensions (``nugget="adaptive"``,
   float32 on the card) fit at seeded hyperparameters, then asked for
   means and variances at 10^6 seeded query points.  The kernels' launch
   counters are zeroed just before and read just after; the first 4096
   queries are held against the same problem run by the port on the CPU in
   float64.

The last three lines of standard output are a JSON object describing each
kernel, the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits with a non-zero code and prints no result.
"""

import json
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
    main_err = 0.0
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
                    main_err = max_abs
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
        "ms": ms,
        "plain_ms": plain_ms,
    }
    return record


def phase_slice(mogp_tpu_torch, km, label):
    import numpy as np
    import torch

    x, y = make_data(N_OUTPUTS)
    thetas = make_thetas()
    q = np.random.RandomState(1).uniform(size=(N_QUERIES, N_DIM))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.launches = 0
    t0 = time.perf_counter()
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    t1 = time.perf_counter()
    mgp.fit(thetas)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = mgp.predict(q)  # returns host arrays: the device work is done
    t3 = time.perf_counter()
    launches = km.launches

    if res.mean.shape != (N_OUTPUTS, N_QUERIES) or res.unc.shape != (N_OUTPUTS, N_QUERIES):
        raise AssertionError("prediction has the wrong shape")
    if not np.isfinite(res.mean).all():
        raise AssertionError("non-finite predictive means")
    if not (np.isfinite(res.unc).all() and (res.unc >= 0).all()):
        raise AssertionError("predictive variances not finite and >= 0")
    if launches <= 0:
        raise AssertionError("the main path did not launch kernel_matrix")
    peak = torch.cuda.max_memory_allocated()
    construct_s, fit_s, predict_s = t1 - t0, t2 - t1, t3 - t2
    print("phase 3: MultiOutputGP {} outputs, n={}, D={}, float32 on {}: construct {} s, "
          "fit {} s, predict {} points {} s = {} points/s ({} output-points/s); "
          "kernel_matrix launches {}; peak device memory {} GB".format(
              N_OUTPUTS, N_POINTS, N_DIM, label, construct_s, fit_s, N_QUERIES, predict_s,
              N_QUERIES / predict_s, N_OUTPUTS * N_QUERIES / predict_s, launches, peak / 1e9))

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
    record["launches"] = phase_slice(mogp_tpu_torch, km, smi)

    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
