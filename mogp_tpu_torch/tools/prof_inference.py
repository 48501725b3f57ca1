"""Where the inference slice's time goes on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.prof_inference [--warmup 60] [--samples 40]
        [--profile-dir build/prof_inference]

The workloads are ``chip_smoke.py`` phase 7's: NUTS on ``bench.py``'s
problem (n = 210, D = 14, ``nugget="fit"``, MAP-fit on the card as 7a
fits it), and SMC on phase 6's 64-output emulator.  It prints, one
labelled line each:

1. ``value_grad[L, eager|graph]``: one batched ``gp_nlp`` value and
   gradient (the potential of every leapfrog) at L = 64 and 256 lanes,
   float32, run op by op and replayed from its CUDA graph
   (``models/inference.py::_GraphedPotential``): CUDA events over 20
   calls, the host's enqueue time of one call, K2 launches per call, and
   the largest difference between the two.
2. ``nuts[dtype, L]``: ``sample_GP_MCMC`` with L = 64 and 256 chains,
   ``--warmup`` + ``--samples`` transitions, float32 and float64: wall
   time, transitions, leapfrogs per transition and per second,
   lane-leapfrogs per second, lane utilization (the share of
   lane-leapfrogs whose result a lane kept under the masks), host syncs
   per transition, divergences, mean acceptance, min ESS per second, K2
   launches per leapfrog.
3. ``profile[nuts L]``: ``torch.profiler`` (CUDA activity) over 5 + 5
   transitions at L = 64 and 256: device busy share against the profiled
   wall time, device kernels launched per leapfrog, device time by kernel
   (top 12).
4. ``vi``: ``fit_GP_VI`` steps per second (400 steps, 8 draws).
5. ``smc``: ``smc_history_match`` at 7f's size (65,536 particles, 10
   stages, 5 MH steps): wall, fused launches per stage; then
   ``profile[smc]`` over one 2-stage run: busy share and device time by
   kernel.

With ``--profile-dir``, the chrome traces of the profiles are written
there.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import mogp_tpu_torch  # noqa: E402
from chip_smoke import (N_DIM, N_OUTPUTS, SMC_MCMC, SMC_PARTICLES, SMC_STAGES,  # noqa: E402
                        make_data, make_thetas, nuts_problem, uq_problem)
from mogp_tpu_torch.models import inference as tinf  # noqa: E402
from mogp_tpu_torch.models.gp import take_lanes  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402
from mogp_tpu_torch.ops import hmc  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402


def _profile(run, label, trace_dir, leapfrogs=None):
    """Busy share, kernels per leapfrog and device time by kernel of
    ``run()`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    hmc.counters.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    lf = hmc.counters.read()["leapfrogs"] if leapfrogs is None else leapfrogs
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    print("profile[{}]: wall {} s, device busy {} s ({}), device kernels {} ({} per leapfrog); "
          "by kernel (ms, count): {}".format(
              label, wall, busy, busy / wall, launches, launches / max(lf, 1),
              json.dumps([(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top])),
          flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, label.replace(" ", "_") + ".json"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=60)
    ap.add_argument("--samples", type=int, default=40)
    ap.add_argument("--profile-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prof_inference: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)

    x, y = nuts_problem()
    np.random.seed(2)
    gp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cuda"), n_tries=4, maxiter=50)
    theta = gp.theta.get_data()
    print("MAP theta:", theta.tolist(), flush=True)
    rng = np.random.RandomState(0)

    for L in (64, 256):
        data = take_lanes(gp._data, torch.zeros(L, dtype=torch.int64, device="cuda"))
        q = torch.as_tensor(theta + 0.3 * rng.randn(L, theta.size), device="cuda")
        outs = {}
        for how, pg in (("eager", tinf._eager_potential(data, gp.kernel, gp.nugget_type)),
                        ("graph", tinf.gp_potential(data, gp.kernel, gp.nugget_type))):
            for _ in range(3):
                pg(q)
            torch.cuda.synchronize()
            kb.launches = 0
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(20):
                outs[how] = pg(q)
            end.record()
            end.synchronize()
            launches = kb.launches / 20
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pg(q)
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            print("value_grad[{}, {}]: {} ms per call (CUDA events, 20 calls), host enqueue of one "
                  "call {} ms, K2 launches per call {}".format(
                      L, how, start.elapsed_time(end) / 20, enqueue * 1e3, launches), flush=True)
        print("value_grad[{}]: graph vs eager, max |d u| {}, max |d grad| {}".format(
            L, float((outs["graph"][0] - outs["eager"][0]).abs().max()),
            float((outs["graph"][1] - outs["eager"][1]).abs().max())), flush=True)

    for dtype in (torch.float32, torch.float64):
        g = gp if dtype == torch.float32 else mogp_tpu_torch.GaussianProcess(
            x, y, nugget="fit", device="cuda", dtype=dtype)
        for L in (64, 256):
            tinf.sample_GP_MCMC(g, n_samples=2, n_warmup=2, n_chains=L, seed=0, theta0=theta)
            torch.cuda.synchronize()
            hmc.counters.reset()
            kb.launches = 0
            t0 = time.perf_counter()
            res = tinf.sample_GP_MCMC(g, n_samples=args.samples, n_warmup=args.warmup, n_chains=L,
                                      seed=1, theta0=theta)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            st = hmc.counters.read()
            print("nuts[{}, {}]: {} + {} transitions in {} s; {}; leapfrogs per transition {}, per "
                  "s {}; lane-leapfrogs per s {}; host syncs per transition {}; divergent share "
                  "{}; mean acceptance {}; max R-hat {}; min ESS per s {}; K2 launches per "
                  "leapfrog {}".format(
                      str(dtype)[6:], L, args.warmup, args.samples, sec, json.dumps(st),
                      st["leapfrogs"] / st["transitions"], st["leapfrogs"] / sec,
                      st["lane_leapfrogs"] / sec, st["syncs"] / st["transitions"],
                      float(res.diverging.mean()), float(res.accept_prob.mean()),
                      float(res.rhat.max()), float(res.ess.min()) / sec,
                      kb.launches / st["leapfrogs"]), flush=True)

    for L in (64, 256):
        _profile(lambda: tinf.sample_GP_MCMC(gp, n_samples=5, n_warmup=5, n_chains=L, seed=2,
                                             theta0=theta), "nuts {}".format(L), args.profile_dir)

    tinf.fit_GP_VI(gp, n_steps=5, theta0=theta, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tinf.fit_GP_VI(gp, n_steps=400, theta0=theta, seed=1)
    print("vi: 400 steps x 8 draws, {} steps/s".format(400 / (time.perf_counter() - t0)),
          flush=True)

    xs, ys = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(xs, ys, nugget="adaptive", device="cuda")
    mgp.fit(make_thetas())
    obs, _, _ = uq_problem()
    kw = dict(obs=obs, bounds=np.array([[0.0, 1.0]] * N_DIM), n_particles=SMC_PARTICLES,
              n_mcmc=SMC_MCMC, rank=1)
    mogp_tpu_torch.smc_history_match(mgp, n_stages=1, seed=0, **kw)
    torch.cuda.synchronize()
    pf.launches = 0
    t0 = time.perf_counter()
    mogp_tpu_torch.smc_history_match(mgp, n_stages=SMC_STAGES, seed=1, **kw)
    torch.cuda.synchronize()
    print("smc: {} particles x {} outputs, {} stages x {} MH steps: {} s, predict_fused launches "
          "{} ({} per stage)".format(SMC_PARTICLES, N_OUTPUTS, SMC_STAGES, SMC_MCMC,
                                     time.perf_counter() - t0, pf.launches,
                                     pf.launches / SMC_STAGES), flush=True)
    _profile(lambda: mogp_tpu_torch.smc_history_match(mgp, n_stages=2, seed=2, **kw), "smc",
             args.profile_dir, leapfrogs=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
