"""Where the MAP fit's time and memory go on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.prof_fit

The problem is ``chip_smoke.py``'s phase 4: a 64-output ``MultiOutputGP``
(n = 210, D = 14, ``nugget="adaptive"``, float32), fit by
``fit_GP_MAP(n_tries=15, maxiter=50)`` after a warm-up fit from seed 0.
It prints, one labelled line each:

1. ``fit[graphed]`` / ``fit[eager]`` / ``fit[plain]``: six timed fits
   from seed 1, in the order graphed, eager, plain, plain, eager, graphed:
   the fit as it runs (its lockstep L-BFGS from the CUDA graphs that the
   warm-up fit captured, ``ops/lbfgs.py``), the same fit with every stage
   eager (``fitting._graphed`` patched to refuse), and the eager fit with
   ``cholesky_batched_plain`` in place of K2; with objective evaluations
   and lanes per fit (the program's own counters ``gp.nlp_lanes``,
   ``lbfgs.evals_graphed`` and ``lbfgs.evals_eager``, read under
   ``utils.metrics.recording()``, as the benchmark reads them), K2
   launches and the phase times.
2. ``objective``: one value + gradient replayed from the captured graph,
   one enqueued eagerly, and one value, at the 960 lanes of the first race
   stage (CUDA events).
3. ``memory``: peak device memory above the starting allocation, and the
   same as (n, n) float32 matrices per lane, for one value + gradient at
   960 lanes on the one-rung ("single") and the full jitter ladder, for a
   3-iteration minimization of all 960 lanes on the full ladder (the
   rescue path's chunk), and for the refit of the 64 winners
   (``MultiOutputGP._fit_lanes``).  ``models/fitting.py``'s
   ``_LANE_MATRICES`` is sized from these.
4. ``profile``: ``torch.profiler`` tables of five evaluations and of one
   whole fit, and the profiled fit's wall time against the mean of the
   unprofiled graphed fits above (the profiler slows the host).  A busy share
   is not printed: a sum of kernel times counts overlapping streams twice
   (``portbench/pbcore/trace.py`` takes their union).
5. ``memory``: the device memory that the captured locksteps hold
   (reserved with them less without them): their graphs' pools and static
   buffers, which no allocation peak sees once they are captured.
"""

import gc
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import mogp_tpu_torch  # noqa: E402
from chip_smoke import MAXITER, N_OUTPUTS, N_TRIES, make_data, time_ms  # noqa: E402
from mogp_tpu_torch.models import fitting  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402
from mogp_tpu_torch.ops import lbfgs  # noqa: E402
from mogp_tpu_torch.utils import metrics  # noqa: E402


def _peak_bytes(fn):
    """Peak device memory allocated by ``fn()`` above what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def _reserved():
    """Device memory the allocator holds once its unused blocks are
    returned."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def main():
    if not torch.cuda.is_available():
        print("prof_fit: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi)
    x, y = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    np.random.seed(0)
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=MAXITER)

    k2_seconds = []

    def timed_fit(label):
        torch.cuda.synchronize()
        np.random.seed(1)
        metrics.clear()
        kb.launches = 0
        t0 = time.perf_counter()
        with metrics.recording():
            mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=MAXITER)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nlp = np.mean([em.current_logpost for em in mgp.emulators])
        counters = metrics.counters()
        print("fit[{}] {} s = {} fits/s; objective evaluations {} (lanes {}; graphed {}, "
              "eager {}); K2 launches {}; phases {}; mean NLP {}".format(
                  label, dt, N_OUTPUTS / dt, metrics.recorder.counts["gp.nlp"],
                  counters["gp.nlp_lanes"], counters.get("lbfgs.evals_graphed", 0),
                  counters.get("lbfgs.evals_eager", 0), kb.launches, fitting.last_phase_times,
                  nlp), flush=True)
        if label == "graphed":
            k2_seconds.append(dt)

    real_chol, real_graphed = tchol.cholesky_batched, fitting._graphed
    try:
        for label in ("graphed", "eager", "plain", "plain", "eager", "graphed"):
            tchol.cholesky_batched = kb.cholesky_batched_plain if label == "plain" else real_chol
            fitting._graphed = real_graphed if label == "graphed" else lambda *a: False
            timed_fit(label)
    finally:
        tchol.cholesky_batched, fitting._graphed = real_chol, real_graphed
    metrics.clear()

    em0 = mgp.emulators[0]
    n = em0.n
    lanes = N_OUTPUTS * N_TRIES
    data = tgp.cat_lanes([em._data for em in mgp.emulators])
    data_all = tgp.take_lanes(data, torch.arange(N_OUTPUTS, device="cuda").repeat_interleave(N_TRIES))
    np.random.seed(1)
    starts = np.concatenate([em.priors.sample_n(N_TRIES) for em in mgp.emulators])
    raw = em0._tensor(starts)

    def value_grad(ladder):
        r = raw.detach().requires_grad_(True)
        f = tgp.gp_nlp(r, data_all, em0.kernel, "adaptive", sparse_ladder=ladder,
                       progressive_ok=False)
        (g,) = torch.autograd.grad(f.sum(), r)
        return f, g

    def value():
        with torch.no_grad():
            return tgp.gp_nlp(raw, data_all, em0.kernel, "adaptive", sparse_ladder="single",
                              progressive_ok=False)

    # the first race stage's captured lockstep, made by the fits above
    entry = next(e for e in lbfgs._entries() if e.ls.x.shape[0] == lanes)
    entry.load(data_all, raw)
    print("objective at {} lanes: value + gradient replayed {} ms, eager {} ms; value {} "
          "ms".format(lanes, time_ms(entry.steps.objective, reps=20),
                      time_ms(lambda: value_grad("single"), reps=20), time_ms(value, reps=20)))
    del entry

    matrix = n * n * torch.finfo(em0._dtype).bits // 8
    winners = [em.theta.get_data() for em in mgp.emulators]
    for label, count, fn in (
        ("value + gradient, single ladder", lanes, lambda: value_grad("single")),
        ("value + gradient, full ladder", lanes, lambda: value_grad(False)),
        ("3-iteration minimization, full ladder", lanes,
         lambda: fitting._run_fit_chunked(mgp.emulators, starts.reshape(N_OUTPUTS, N_TRIES, -1),
                                          3, None, None, False)),
        ("refit of the winners", N_OUTPUTS,
         lambda: mgp._fit_lanes(list(range(N_OUTPUTS)), winners)),
    ):
        peak = _peak_bytes(fn)
        print("memory: {} at {} lanes: peak {} GB above the start = {} (n, n) matrices per "
              "lane".format(label, count, peak / 1e9, peak / (count * matrix)), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            value_grad("single")
        torch.cuda.synchronize()
    print("profile: 5 evaluations at {} lanes".format(lanes))
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))

    np.random.seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=MAXITER)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    metrics.clear()   # the profiled fit's spans: read here by nothing
    print("profile: one fit: wall {} ms against the unprofiled fit's {} ms".format(
        wall_ms, 1e3 * float(np.mean(k2_seconds))))
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    shapes = sorted(e.ls.x.shape[0] for e in lbfgs._entries())
    held = _reserved()
    lbfgs.clear_graphs()
    pools = held - _reserved()
    print("memory: the captured locksteps of {} lanes hold {} GB = {} (n, n) matrices per "
          "lane".format(shapes, pools / 1e9, pools / (sum(shapes) * matrix)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
