"""Where the serving path's prediction time goes on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mogp_tpu_torch.tools.prof_predict

The problem is ``chip_smoke.py``'s phase 3: a 64-output ``MultiOutputGP``
(n = 210, D = 14, ``nugget="adaptive"``, float32) fit at seeded
hyperparameters, predicting means and variances at 10^6 seeded queries.
It prints, one labelled line each:

1. ``predict``: three unprofiled predicts (wall seconds, points/s) after a
   warm-up, with the launches of the fused kernel and of K1 in each.
2. ``stages``: one predict taken apart by the host clock, each stage ended
   by a synchronize: the host's float64 output arrays, the lanes' stacking
   and the queries and their design matrix to the device
   (``MultiOutputGP._predict_groups``), the device call over the query
   tiles, and the results to the host, widened to float64 there into the
   output arrays.
3. ``profile``: a ``torch.profiler`` table of one predict; its device time
   (the sum over device kernels and copies) and its busy share against the
   profiled wall time and against the mean unprofiled predict (the
   profiler slows the host).
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
from chip_smoke import N_DIM, N_OUTPUTS, N_QUERIES, make_data, make_thetas  # noqa: E402
from mogp_tpu_torch.models.mogp import _cat_tiles, _store_rows  # noqa: E402
from mogp_tpu_torch.ops import kernel_matrix as km  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as pf  # noqa: E402


def _stages(mgp, q):
    """One predict of every output as ``MultiOutputGP.predict`` runs it,
    timed stage by stage."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shape = (mgp.n_emulators, q.shape[0])
    mean_out, unc_out = np.empty(shape), np.empty(shape)
    t1 = time.perf_counter()
    (rows, tiles, scale, shift), = mgp._predict_groups(q, list(range(mgp.n_emulators)))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mu, var = _cat_tiles(tiles)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    _store_rows(mean_out, rows, mu, scale[:, None], shift[:, None])
    _store_rows(unc_out, rows, var, scale[:, None] ** 2)
    t4 = time.perf_counter()
    return {"outputs_alloc_s": t1 - t0, "to_device_s": t2 - t1, "device_call_s": t3 - t2,
            "to_host_s": t4 - t3, "total_s": t4 - t0}


def main():
    if not torch.cuda.is_available():
        print("prof_predict: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi)
    x, y = make_data(N_OUTPUTS)
    q = np.random.RandomState(1).uniform(size=(N_QUERIES, N_DIM))
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    mgp.fit(make_thetas())
    mgp.predict(q)  # warm-up: the kernel build and the allocator

    walls = []
    for _ in range(3):
        pf.launches = km.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgp.predict(q)
        walls.append(time.perf_counter() - t0)
        print("predict: {} points in {} s = {} points/s; predict_fused launches {}, "
              "kernel_matrix launches {}".format(N_QUERIES, walls[-1], N_QUERIES / walls[-1],
                                                 pf.launches, km.launches), flush=True)
    print("stages:", _stages(mgp, q), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mgp.predict(q)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in table
                    if e.device_type == DeviceType.CUDA) / 1e3
    mean_ms = 1e3 * float(np.mean(walls))
    print("profile: one predict: wall {} ms, device time {} ms, device busy {} % of it, {} % "
          "of the unprofiled predict's {} ms".format(wall_ms, device_ms, 100 * device_ms / wall_ms,
                                                    100 * device_ms / mean_ms, mean_ms))
    print(table.table(sort_by="self_cuda_time_total", row_limit=20, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
