"""Large-n GP on one CUDA card: the fit, one optimizer step, the NLP check.

Port of ``benchmarks/benchmark_large_n.py``.  Run from the root of a
checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.large_n [--sizes 4096,8192] [--iters 5] [--no-oracle]
        [--profile DIR]

The problem is ``benchmark_large_n.py:34-39``: n points in D = 8, x ~
U(0, 1) from ``RandomState(0)``, y = sin(4 x0) cos(2 x1) + sum_{i>=2} xi,
raw theta = [0.2] * 8 + [0.5]; zero mean, SquaredExponential,
``nugget="adaptive"``, float32 on the card.  Above n = 1024 the fit's
jitter ladder is progressive (one factorization per rung, through the
blocked K3-K5 route).  For each n it prints one line and, at the end, a
JSON line ``{"metric": "large_n_sweep", "results": [...]}`` with

* ``t_fit_ms``: wall time of ``GaussianProcess.fit`` (the fit artifacts;
  each fit ends with its summary on the host), the median of ``iters``
  warm fits, each timed alone (``t_fit_samples_ms``);
* ``tflops``: ``flops_gp_nlp(n, 8, adaptive_candidates=rungs)`` over
  ``t_fit``, with ``rungs`` the ladder rungs the fit ran, read from the
  realized nugget as ``bench.py:344-356`` does.  It counts a whole
  factorization for each rung, but a failed rung stops at the panel of its
  failing pivot, so it is an upper bound of the rate;
* ``tflops_run``: the FLOPs that ran over ``t_fit``: the failed rungs up
  to the panel where they stopped (``fail_cols``, read back from the
  route), the last rung whole;
* ``t_valgrad_ms``: one optimizer step where the objective is finite, the
  value and gradient of ``gp_nlp`` by autograd at the realized nugget
  (fixed); ``t_valgrad_single_ms``: the objective
  ``benchmark_large_n.py:106-121`` times, ``sparse_ladder="single"``, NaN
  where the fit needs more than that one rung's jitter (its factorization
  then stops early; ``valgrad_single_finite`` says which);
* ``nlp_rel_err``: against the port on the CPU in float64 at the card's
  realized nugget (skipped with ``--no-oracle``);
* ``phases_s``: the tool's own seconds by phase.

With ``--profile DIR`` it also prints, for each n, ``torch.profiler``
tables (device time by kernel) of one warm fit, with the fit's device time
as a share of the profiled fit's wall time and of the unprofiled
``t_fit``, and of one factorization of the fit's matrix by each blocked
variant; the Chrome traces go under ``DIR``.

Without a CUDA device it exits with an error: a time taken on the CPU is
not a time of the card.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_DIM = 8


def make_problem(n, seed=0):
    """``benchmarks/benchmark_large_n.py:34-39``."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(n, N_DIM))
    y = np.sin(4 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(axis=1)
    theta = np.concatenate([0.2 * np.ones(N_DIM), [0.5]])
    return x, y, theta


def ladder_rungs(nugget, sigma2, n):
    """Rungs of the adaptive jitter ladder a fit ran, from its realized
    nugget (``bench.py:344-356``): 0 -> 1 rung; ``1e-6 * 10**k * sigma2``
    -> k + 2 rungs; below the progressive threshold every rung runs."""
    from ..ops.cholesky import PROGRESSIVE_LADDER_MIN_N

    if n < PROGRESSIVE_LADDER_MIN_N:
        return 6
    if nugget == 0.0:
        return 1
    return int(round(math.log10(nugget / (1e-6 * sigma2)))) + 2


def cpu_logpost(x, y, theta, nugget="adaptive"):
    """The port's fit on the CPU in float64: ``(logpost, realized nugget)``;
    a float ``nugget`` fits at that nugget, fixed."""
    from .. import GaussianProcess

    gp = GaussianProcess(x, y, nugget=nugget, device="cpu")
    gp.fit(theta)
    return gp.current_logpost, gp.nugget


def covariance(gp, theta):
    """``K`` ``(1, n, n)`` of the ``GaussianProcess`` ``gp`` at raw
    ``theta``, sigma^2 included, no nugget: what its fit factors."""
    raw = gp._tensor(theta)[None]
    n_corr = gp.kernel.get_n_params(gp._data.inputs)
    return torch.exp(raw[:, n_corr])[:, None, None] * gp.kernel.kernel_f(
        gp._data.inputs, gp._data.inputs, raw[:, :n_corr])


def jittered_K(gp, theta):
    """``K + nugget I`` of the fit ``gp`` at raw ``theta``: the ``(1, n,
    n)`` matrix its chosen ladder rung factored."""
    K = covariance(gp, theta)
    return K + gp.nugget * torch.eye(gp.n, dtype=K.dtype, device=K.device)


def failed_rung_columns(gp, theta, rungs):
    """The 1-based columns at which the ``rungs - 1`` failed rungs of
    ``gp``'s progressive fit at ``theta`` stopped: each rung's matrix, built
    as ``jit_cholesky`` builds it, factored again by the route's blocked
    variant, whose ``info`` is that column.  Raises unless exactly the last
    of the ``rungs`` factors.  For n above K2's bound (the progressive
    ladder's sizes)."""
    from ..ops.cholesky import jitter_ladder
    from ..ops.cholesky_batched import route
    from ..ops.cholesky_blocked import cholesky_blocked_ex

    K = covariance(gp, theta)
    jitters = jitter_ladder(K)
    eye = torch.eye(gp.n, dtype=K.dtype, device=K.device)
    variant = route(gp.n, K.dtype)
    infos = [int(cholesky_blocked_ex(K + jitters[..., k, None, None] * eye, variant)[1][0])
             for k in range(rungs)]
    if 0 in infos[:-1] or infos[-1] != 0:
        raise RuntimeError("the rungs of the fit at n={} do not factor as it did: info "
                           "{}".format(gp.n, infos))
    return infos[:-1]


def cholesky_flops_run(n, fail_cols):
    """FLOPs of the factorizations of one progressive fit: the last rung's
    whole, and for each failed rung the panels before the one that holds its
    failing pivot (``fail_cols``, 1-based), where the blocked route stops
    the matrix.  The failing panel's own diagonal block (under ``PANEL**3 /
    3`` FLOPs) is not counted."""
    from ..ops.cholesky_blocked import PANEL
    from ..utils.metrics import flops_cholesky

    done = [(c - 1) // PANEL * PANEL for c in fail_cols]
    return flops_cholesky(n) + sum(flops_cholesky(n) - flops_cholesky(n - b) for b in done)


def _sync():
    torch.cuda.synchronize()


def _wall_seconds(fn, reps):
    """Wall seconds of each of ``reps`` calls of ``fn()``, each from and to a
    synchronized card."""
    samples = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        samples.append(time.perf_counter() - t0)
    return samples


def _valgrad(gp, theta, reps, **nlp_kw):
    """Mean wall ms of one value and gradient of ``gp_nlp`` at raw ``theta``
    by autograd, after one warm-up, and whether both came out finite."""
    from ..models.gp import gp_nlp

    raw = gp._tensor(theta)[None]

    def valgrad():
        r = raw.clone().requires_grad_(True)
        v = gp_nlp(r, gp._data, gp.kernel, gp.nugget_type, **nlp_kw)
        (g,) = torch.autograd.grad(v.sum(), r)
        return v, g

    valgrad()
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        v, g = valgrad()
    _sync()
    return ((time.perf_counter() - t0) / reps * 1e3,
            bool(torch.isfinite(v).all() and torch.isfinite(g).all()))


def measure(n, iters=5, oracle=True):
    """One row of the sweep at size ``n`` on the current CUDA device;
    returns ``(row, gp)`` with ``gp`` the fit ``GaussianProcess``."""
    from .. import GaussianProcess
    from ..utils.metrics import PhaseTimer, flops_gp_nlp, tflops_per_sec

    timers = PhaseTimer()
    x, y, theta = make_problem(n)
    gp = GaussianProcess(x, y, nugget="adaptive", device="cuda")
    with timers.phase("fits"):
        (t_first,) = _wall_seconds(lambda: gp.fit(theta), 1)
        samples = _wall_seconds(lambda: gp.fit(theta), iters)
    t_fit = float(np.median(samples))
    rungs = ladder_rungs(gp.nugget, math.exp(theta[N_DIM]), n)
    with timers.phase("failed rungs"):
        fail_cols = failed_rung_columns(gp, theta, rungs)
    flops_run = flops_gp_nlp(n, N_DIM, adaptive_candidates=0) + cholesky_flops_run(n, fail_cols)

    with timers.phase("value + gradient"):
        # an optimizer step where the objective is finite: at the realized
        # nugget, fixed; and the one-rung objective benchmark_large_n.py
        # times, NaN where the fit needs a higher rung (its factorization
        # then stops at the failing panel)
        fixed = GaussianProcess(x, y, nugget=gp.nugget, device="cuda")
        t_vg, vg_finite = _valgrad(fixed, theta, iters)
        t_vg1, vg1_finite = _valgrad(gp, theta, iters, sparse_ladder="single")
        del fixed

    row = dict(n=n, dtype=str(gp._dtype).replace("torch.", ""), t_first_fit_ms=t_first * 1e3,
               t_fit_ms=t_fit * 1e3, t_fit_samples_ms=[t * 1e3 for t in samples], rungs=rungs,
               fail_cols=fail_cols,
               tflops=tflops_per_sec(flops_gp_nlp(n, N_DIM, adaptive_candidates=rungs), t_fit),
               tflops_run=tflops_per_sec(flops_run, t_fit),
               t_valgrad_ms=t_vg, valgrad_finite=vg_finite,
               t_valgrad_single_ms=t_vg1, valgrad_single_finite=vg1_finite,
               nlp=gp.current_logpost, nugget=gp.nugget)
    if oracle:
        with timers.phase("CPU oracle"):
            nlp64, _ = cpu_logpost(x, y, theta, nugget=gp.nugget)
        row.update(nlp_cpu64=nlp64, nlp_rel_err=abs(gp.current_logpost - nlp64) / abs(nlp64))
    row["phases_s"] = dict(timers.totals)
    return row, gp


def profile(gp, theta, logdir, t_fit_ms):
    """Print the ``torch.profiler`` tables of one warm ``gp.fit(theta)`` and
    of one factorization of its ``K + nugget I`` by each blocked variant;
    ``t_fit_ms`` is the unprofiled fit's wall time."""
    from torch.autograd import DeviceType

    from ..ops.cholesky_blocked import VARIANTS, cholesky_blocked
    from ..utils.metrics import profile_trace

    def report(label, prof, wall_ms, plain_ms):
        table = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in table
                        if e.device_type == DeviceType.CUDA) / 1e3
        print("profile: {}: wall {} ms, device time {} ms, device busy {} % of it, {} % of the "
              "unprofiled {} ms".format(label, wall_ms, device_ms, 100 * device_ms / wall_ms,
                                        100 * device_ms / plain_ms, plain_ms))
        print(table.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=70),
              flush=True)

    def profiled(name, fn):
        # twice: the first profiled run also pays the profiler's start-up
        for _ in range(2):
            _sync()
            t0 = time.perf_counter()
            with profile_trace(os.path.join(logdir, name)) as prof:
                fn()
                _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    n = gp.n
    prof, wall_ms = profiled("fit_{}".format(n), lambda: gp.fit(theta))
    report("one fit at n={}".format(n), prof, wall_ms, t_fit_ms)

    K = jittered_K(gp, theta)
    for v in VARIANTS:
        plain_ms = 1e3 * float(np.median(_wall_seconds(lambda: cholesky_blocked(K, v), 6)[1:]))
        prof, wall_ms = profiled("{}_{}".format(v, n), lambda: cholesky_blocked(K, v))
        report("one {} factorization at n={}".format(v, n), prof, wall_ms, plain_ms)


def format_row(row):
    return ("n={n:5d} {dtype}: t_fit={t_fit_ms:.3f} ms (median of {samples}; {rungs} rungs, the "
            "failed ones stopped at columns {fail_cols}; first fit {t_first_fit_ms:.1f} ms) "
            "{tflops_run:.4f} TFLOP/s run ({tflops:.4f} counting every rung whole)  "
            "t_v&g={t_valgrad_ms:.3f} ms at the realized nugget (finite {valgrad_finite}), "
            "{t_valgrad_single_ms:.3f} ms one-rung (finite {valgrad_single_finite})  "
            "nlp={nlp!r} nugget={nugget!r}".format(
                samples="[{}]".format(", ".join("{:.3f}".format(t) for t in row["t_fit_samples_ms"])),
                **row)
            + ("  nlp_cpu64={nlp_cpu64!r} (same nugget) nlp_rel={nlp_rel_err:.3e}".format(**row)
               if "nlp_rel_err" in row else "")
            + "  tool phases (s) {}".format(row["phases_s"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="4096,8192")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--profile", metavar="DIR", help="also profile each size, traces under DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("large_n: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)
    results = []
    for n in (int(s) for s in args.sizes.split(",")):
        row, gp = measure(n, iters=args.iters, oracle=not args.no_oracle)
        print(format_row(row), flush=True)
        results.append(row)
        if args.profile:
            profile(gp, make_problem(n)[2], args.profile, row["t_fit_ms"])
        del gp
    print(json.dumps({"metric": "large_n_sweep", "card": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
