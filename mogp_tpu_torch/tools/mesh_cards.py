"""The multi-device layer over every card of one machine.

Run from the root of a checkout, on a machine with two or more CUDA cards:

    python3 -m mogp_tpu_torch.tools.mesh_cards

``auto_mesh()`` takes every card, so each shard runs on a host thread of
its own (``parallel/mesh.py::map_shards``).  Each path of
``chip_smoke.py``'s phase 10 runs once on ``cuda:0`` alone and once over
the mesh, after a warm-up of both, and prints one labelled line: the wall
seconds of both, the kernels' launches over the mesh, and how the sharded
result compares with the unsharded one:

1. ``fit``: phase 4's MAP fit (64 outputs x 15 restarts, ``maxiter=50``).
2. ``sweep``: phase 6's history-matching sweep over 10^7 uniform coords
   (drawn by numpy directly, not by ``MonteCarloDesign``'s slow PPF).
3. ``smc``: phase 7f's ``smc_history_match`` (65,536 particles).
4. ``nuts``: 7a's GP, ``NUTS_CHAINS`` chains of 20 + 20, trees of at most
   63 leapfrogs.
5. ``mice``: 2 steps of phase 8a (25 candidate blocks padded to a multiple
   of the cards).

Every comparison must hold (phase 10's rules), else it exits with 1.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402
from mogp_tpu_torch.ops import cholesky_blocked as kbl  # noqa: E402
from mogp_tpu_torch.ops import kernel_matrix as km  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402
from mogp_tpu_torch.parallel import auto_mesh  # noqa: E402

NUTS_CHAINS = 8


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0


def _both(name, run, compare):
    """``run(mesh)`` unsharded (``None``) and over the mesh, each warmed up
    once; prints the line and returns whether ``compare`` holds."""
    mesh = auto_mesh()
    run(None)
    run(mesh)
    ref, t_one = _timed(lambda: run(None))
    cs._zero(km, kb, kbl, pf)
    got, t_mesh = _timed(lambda: run(mesh))
    launches = cs._launches(km, kb, kbl, pf)
    ok, detail = compare(got, ref)
    print("{}: cuda:0 alone {} s, over {} {} s ({}x); launches over the mesh {}; {}: {}".format(
        name, t_one, mesh, t_mesh, t_one / t_mesh, launches, json.dumps(detail),
        "ok" if ok else "FAIL"), flush=True)
    return ok


def main():
    n = torch.cuda.device_count()
    if n < 2:
        print("mesh_cards: needs two or more CUDA devices, found {}".format(n), file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    mesh = auto_mesh()
    print("cards: {}; mesh {}, threaded {}".format(smi.replace("\n", "; "), mesh, mesh.threaded))
    if not mesh.threaded:
        raise AssertionError("a mesh of distinct cards must run its shards on threads")
    ok = []

    x, y = cs.make_data(cs.N_OUTPUTS)

    def fit(m):
        mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
        np.random.seed(1)
        mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=cs.N_TRIES, maxiter=cs.MAXITER, mesh=m)
        return np.stack([em.theta.get_data() for em in mgp.emulators])

    ok.append(_both("fit", fit, lambda a, b: (
        len(a) == cs.N_OUTPUTS and np.isfinite(a).all(),
        {"outputs_bit_identical": int(sum(np.array_equal(p, q) for p, q in zip(a, b))),
         "max_abs_d_theta": float(np.max(np.abs(a - b)))})))

    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    mgp.fit(cs.make_thetas())
    obs, _, _ = cs.uq_problem()
    coords = np.random.RandomState(6).uniform(size=(cs.N_SWEEP, cs.N_DIM))

    def sweep(m):
        hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords, mesh=m)
        return hm.get_implausibility(0.0, 1), hm.get_NROY()

    ok.append(_both("sweep", sweep, lambda a, b: (
        float(np.max(np.abs(a[0] - b[0]) / b[0])) <= cs.MESH_RTOL and a[1] == b[1],
        {"max_rel_d_I": float(np.max(np.abs(a[0] - b[0]) / b[0])), "same_nroy": a[1] == b[1],
         "nroy": len(b[1])})))
    del coords

    kw = dict(obs=obs, bounds=np.array([[0.0, 1.0]] * cs.N_DIM), n_particles=cs.SMC_PARTICLES,
              n_stages=cs.SMC_STAGES, n_mcmc=cs.SMC_MCMC, rank=1, seed=1)

    def smc(m):
        return mogp_tpu_torch.smc_history_match(mgp, mesh=m, **kw)

    def smc_cmp(a, b):
        d_p = float(np.max(np.abs(a.particles - b.particles)) / np.max(np.abs(b.particles)))
        d_i = float(np.max(np.abs(a.implausibility - b.implausibility) / b.implausibility))
        return d_p <= cs.MESH_RTOL and d_i <= cs.MESH_RTOL, {"particles": d_p, "I_rel": d_i}

    ok.append(_both("smc", smc, smc_cmp))

    xn, yn = cs.nuts_problem()
    np.random.seed(2)
    gp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(xn, yn, nugget="fit", device="cuda"), n_tries=4,
        maxiter=50)
    nkw = dict(n_chains=NUTS_CHAINS, n_samples=cs.NUTS_MESH_ITERS, n_warmup=cs.NUTS_MESH_ITERS,
               seed=cs.NUTS_MESH_SEED, max_depth=cs.NUTS_MESH_DEPTH, theta0=gp.theta.get_data())

    def nuts(m):
        return mogp_tpu_torch.sample_GP_MCMC(gp, mesh=m, **nkw)

    def nuts_cmp(a, b):
        s, s0 = a.samples, b.samples
        sd = np.sqrt(0.5 * (s.reshape(-1, s.shape[-1]).var(axis=0)
                            + s0.reshape(-1, s0.shape[-1]).var(axis=0)))
        mcse = sd * np.sqrt(1.0 / np.maximum(a.ess, 1.0) + 1.0 / np.maximum(b.ess, 1.0))
        z = float(np.max(np.abs(s.mean(axis=(0, 1)) - s0.mean(axis=(0, 1))) / mcse))
        same = int(sum(np.array_equal(s[c], s0[c]) for c in range(NUTS_CHAINS)))
        return (bool(np.isfinite(s).all()) and z <= cs.NUTS_MESH_MCSE,
                {"chains_bit_identical": same, "pooled_mean_d_over_mcse": z})

    ok.append(_both("nuts", nuts, nuts_cmp))

    def mice(m):
        md = cs.mice_device_design(mogp_tpu_torch, device="cuda", mesh=m)
        for _ in range(cs.MICE_MESH_STEPS):
            md.run_next_point()
        return md.inputs[cs.MICE_INIT:]

    ok.append(_both("mice", mice, lambda a, b: (bool(np.array_equal(a, b)),
                                                {"chosen": a.tolist()})))
    print("mesh_cards: {}".format("ok" if all(ok) else "FAIL"))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
