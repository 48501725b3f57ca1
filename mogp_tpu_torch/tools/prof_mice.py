"""Where a MICE acquisition step's time goes on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.prof_mice

The problem is ``chip_smoke.py``'s phase 8a: ``DeviceMICEDesign`` on
Branin, 16 initial points, 10^5 candidates in blocks of 4096, 8 restarts x
``maxiter=60``, float32.  It prints, one labelled line each:

1. ``step``: three acquisition steps, each split into the fit and the score
   step (host clock, ending in a synchronize), with the objective
   evaluations of the fit and the launches of each kernel.
2. ``objective``: one value + gradient of the masked objective at the
   fit's 8 lanes (CUDA events).
3. ``score part``: the score step's parts at the last step's shapes (CUDA
   events): the fused prediction at every candidate, the 25 K1 builds of
   the blocks' covariances, one factorization of the 25 blocks by the
   blocked route, the lower solve of the identity, and ``cholesky_ex`` of
   the same blocks beside them.
4. ``profile``: a ``torch.profiler`` table of one more step; its device
   time (the sum over device kernels) and busy share of its wall time.
"""

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
from mogp_tpu_torch.models.gp import make_gp_data, take_lanes  # noqa: E402
from mogp_tpu_torch.models.priors import GPPriors  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402
from mogp_tpu_torch.ops import cholesky_blocked as kbl  # noqa: E402
from mogp_tpu_torch.ops import kernel_matrix as km  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402
from mogp_tpu_torch.ops.cholesky import ChoFactor, cholesky_factor  # noqa: E402
from mogp_tpu_torch.uq import mice_device as tmd  # noqa: E402


def _launches():
    return {"K1": km.launches, "fused": pf.launches, "K2": kb.launches, **kbl.launches}


def main():
    if not torch.cuda.is_available():
        print("prof_mice: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi)
    md = cs.mice_device_design(mogp_tpu_torch, device="cuda")

    evals = {"n": 0}
    real_nlp = tmd.masked_gp_nlp

    def counting(*args, **kw):
        evals["n"] += 1
        return real_nlp(*args, **kw)

    tmd.masked_gp_nlp = counting
    try:
        with cs._step_timer(tmd) as timer:
            for i in range(3):
                evals["n"] = 0
                before = _launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                md.run_next_point()
                wall = time.perf_counter() - t0
                after = _launches()
                print("step {}: {} s (fit {} s, {} objective evaluations; score {} s); launches "
                      "{}".format(i, wall, timer.split["fit"][-1], evals["n"],
                                  timer.split["score"][-1],
                                  {k: after[k] - before[k] for k in after}), flush=True)
    finally:
        tmd.masked_gp_nlp = real_nlp

    # the last step's buffers and hyperparameters, on the card
    x_buf, y_buf, mask, n_obs = cs._mice_step_state(md)
    priors = GPPriors.default_priors(md.inputs[:n_obs], 2, nugget_type="adaptive")
    data = make_gp_data(x_buf, y_buf, np.zeros((md.n_max, 0)), priors, device="cuda")
    mask = torch.as_tensor(mask, dtype=torch.float32, device="cuda")
    lanes = take_lanes(data, torch.zeros(md.n_tries, dtype=torch.int64, device="cuda"))
    starts = torch.as_tensor(priors.sample_n(md.n_tries), dtype=torch.float32, device="cuda")

    def value_grad():
        r = starts.detach().requires_grad_(True)
        f = tmd.masked_gp_nlp(r, lanes, mask, md._kernel, "adaptive", sparse_ladder="single")
        return torch.autograd.grad(f.sum(), r)

    print("objective: value + gradient at {} lanes, n_max {}: {} ms".format(
        md.n_tries, md.n_max, cs.time_ms(value_grad, reps=20)))

    raw = torch.as_tensor(md.get_current_theta(), dtype=torch.float32, device="cuda")[None]
    sigma2 = torch.exp(raw[:, 2])
    K = sigma2[:, None, None] * md._kernel.kernel_f(data.inputs, data.inputs, raw[:, :2])
    Kinv, nug = cholesky_factor(tmd._masked_cov(K, mask), torch.zeros_like(sigma2), "adaptive",
                                jitter_mask=mask)
    L_obs = Kinv.L[:, :n_obs, :n_obs]
    alpha = ChoFactor(L_obs).solve(data.targets[:, :n_obs])
    cands = np.tile(md.candidates[:1], (md._n_cand_pad, 1))
    cands[:md.n_cand] = md.candidates
    blocks = torch.as_tensor(cands.reshape(-1, cs.MICE_BLOCK, 2), dtype=torch.float32,
                             device="cuda")
    cmask = torch.ones(blocks.shape[:2], device="cuda")
    flat = blocks.reshape(-1, 2)
    C = tmd._cand_cov(md._kernel, blocks, cmask, raw[:, :2], sigma2)
    Q = C + 1e-3 * torch.eye(cs.MICE_BLOCK, device="cuda")
    Lq = kbl.cholesky_blocked(Q.contiguous(), kb.route(cs.MICE_BLOCK, torch.float32))
    eye = torch.eye(cs.MICE_BLOCK, device="cuda").expand_as(Lq)
    parts = {
        "fused prediction, {} candidates, n = {}".format(flat.shape[0], n_obs): lambda:
            tmd._base_predict(md._kernel, data, raw, L_obs, alpha, nug, flat),
        "K1 builds of {} blocks".format(blocks.shape[0]): lambda:
            tmd._cand_cov(md._kernel, blocks, cmask, raw[:, :2], sigma2),
        "one blocked factorization of {}".format(tuple(Q.shape)): lambda:
            kbl.cholesky_blocked(Q, kb.route(cs.MICE_BLOCK, torch.float32)),
        "cholesky_ex of the same": lambda: torch.linalg.cholesky_ex(Q),
        "lower solve of the identity": lambda:
            torch.linalg.solve_triangular(Lq, eye, upper=False),
    }
    for label, fn in parts.items():
        print("score part: {}: {} ms".format(label, cs.time_ms(fn, reps=5, warmup=1)), flush=True)
    del C, Q, Lq, eye

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        md.run_next_point()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in table
                    if e.device_type == DeviceType.CUDA) / 1e3
    print("profile: one step: wall {} ms, device time {} ms, busy {} %".format(
        wall_ms, device_ms, 100 * device_ms / wall_ms))
    print(table.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
