"""Where the UQ slice's time goes on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.uq_timing

The problem is ``chip_smoke.py``'s phase 6: the headline 64-output
``MultiOutputGP`` (n = 210, D = 14, ``nugget="adaptive"``, float32) fit at
seeded hyperparameters, its observations, and Monte Carlo coords.  It
prints, one labelled line each:

1. ``crossover``: the implausibility (rank 1) by the host path
   (``MultiOutputGP.predict``, then ``get_implausibility``'s numpy on
   those expectations) and by the device sweep
   (``HistoryMatching._device_implausibility``), at 2^0 to 2^22 coords, in
   turns (host, device, device, host), wall seconds: below 2^16 the median
   of five such turns, from 2^16 the mean of one; then the smallest size
   from which the device sweep is the faster at every larger size
   measured: the value for ``uq/history_matching.py``'s
   ``_DEVICE_SWEEP_MIN_COORDS``.
2. ``sweep``: the 10^7-coord device sweep taken apart: its wall time,
   the host's share (the coords' float32 tensors, the final
   ``np.partition``, timed alone on the same arrays), and a
   ``torch.profiler`` table of one sweep (the fused kernel, the top-k, the
   copies each way).
3. ``pivoted``: ``pivoted_cholesky`` of the emulators' K at (64, 210) and
   (960, 210) in float32 (CUDA events around the host-bound loop, so
   they measure the host's dispatch), its search and its differentiable
   build timed apart, beside one ``cholesky_batched`` (K2) of the same
   matrices.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import mogp_tpu_torch  # noqa: E402
from chip_smoke import (N_OUTPUTS, N_SWEEP, make_data, make_thetas, time_ms,  # noqa: E402
                        uq_coords, uq_problem)
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402

SIZES = [2**k for k in range(0, 23)]


def _sweep_s(mgp, obs, coords, device):
    """Wall seconds of one implausibility by the chosen path, whatever
    ``_DEVICE_SWEEP_MIN_COORDS`` would choose."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if device:
        hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords)
        hm._device_implausibility(np.atleast_1d(0.0), 1)
    else:
        mogp_tpu_torch.HistoryMatching(obs=obs, expectations=mgp.predict(coords)
                                       ).get_implausibility(0.0, 1)
    return time.perf_counter() - t0


def crossover(mgp, obs, coords):
    rows = []
    _sweep_s(mgp, obs, coords[:2**16], False)  # warm-up of both paths
    _sweep_s(mgp, obs, coords[:2**16], True)
    for m in SIZES:
        c = coords[:m]
        turns = np.array([[_sweep_s(mgp, obs, c, dev) for dev in (False, True, True, False)]
                          for _ in range(5 if m < 2**16 else 1)])
        host, dev = np.median(turns[:, [0, 3]]), np.median(turns[:, [1, 2]])
        rows.append((m, host, dev))
        print("crossover: {} coords: host path {} s, device sweep {} s ({}x); turns {}".format(
            m, host, dev, host / dev, turns.tolist()), flush=True)
    faster = [d < h for _, h, d in rows]
    first = next((rows[i][0] for i in range(len(rows)) if all(faster[i:])), None)
    print("crossover: the device sweep is the faster from {} coords on (of {})".format(
        first, SIZES))


def sweep_breakdown(mgp, obs, coords):
    hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords)
    hm.get_implausibility(0.0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hm.get_implausibility(0.0, 1)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.as_tensor(coords, dtype=mgp.emulators[0]._dtype)
    cast = time.perf_counter() - t0
    allk = np.random.RandomState(0).rand(2, coords.shape[0])
    t0 = time.perf_counter()
    np.partition(allk, 0, axis=0)
    part = time.perf_counter() - t0

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hm.get_implausibility(0.0, 1)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    table = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in table
                    if e.device_type == DeviceType.CUDA) / 1e3
    print("sweep: {} coords x {} outputs: wall {} s ({} points/s); host float64 -> float32 "
          "tensors of the coords {} s; np.partition of the (2, {}) top-k {} s; profiled wall {} "
          "s, device busy {} ms ({} % of the unprofiled wall)".format(
              coords.shape[0], N_OUTPUTS, wall, coords.shape[0] / wall, cast, coords.shape[0],
              part, prof_wall, device_ms, 100 * device_ms / (1e3 * wall)))
    print(table.table(sort_by="self_cuda_time_total", row_limit=15, max_name_column_width=60))


def pivoted(mgp):
    ems = mgp.emulators
    K64 = torch.stack([
        torch.exp(em._tensor(em.theta.get_data())[-1])
        * em.kernel.kernel_f(em._data.inputs, em._data.inputs,
                             em._tensor(em.theta.get_data())[None, :-1])[0]
        for em in ems])
    for K in (K64, K64.repeat(15, 1, 1)):
        perm, rank = tchol._pivot_search(K)
        Kj = K + 1e-4 * torch.eye(K.shape[-1], device=K.device)
        whole = time_ms(lambda: tchol.pivoted_cholesky(K), reps=10, warmup=2)
        search = time_ms(lambda: tchol._pivot_search(K), reps=10, warmup=2)
        build = time_ms(lambda: tchol._pivoted_factor(K, perm, rank), reps=10, warmup=2)
        chol = time_ms(lambda: kb.cholesky_batched(Kj), reps=10, warmup=2)
        print("pivoted: pivoted_cholesky {} float32: {} ms (the search alone {} ms, the build "
              "alone {} ms); cholesky_batched of the same (+1e-4 I) {} ms; ranks {}..{}".format(
                  tuple(K.shape), whole, search, build, chol, int(rank.min()), int(rank.max())),
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("uq_timing: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi)
    x, y = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    mgp.fit(make_thetas())
    obs = uq_problem()[0]
    coords = uq_coords(mogp_tpu_torch.MonteCarloDesign, N_SWEEP)
    pivoted(mgp)
    crossover(mgp, obs, coords)
    sweep_breakdown(mgp, obs, coords)
    return 0


if __name__ == "__main__":
    sys.exit(main())
