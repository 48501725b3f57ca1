#!/usr/bin/env python3
"""mogp_tpu's own float32-vs-float64 gap on the CPU for the quantities that
``chip_smoke.py`` phase 6 holds the port to.

Run from the root of a checkout (JAX on the CPU, no card needed):

    python3 scripts/uq_reference_gap.py

The problem is phase 6's: the headline 64-output ``MultiOutputGP`` (n =
210, D = 14, ``nugget="adaptive"``) fit at ``make_thetas()``; the
implausibility (rank 1, no discrepancy) at the first 4096 of its Monte
Carlo coords; the standard and pivoted errors and the scaled Mahalanobis
distances of its 210 validation points; the log posterior of a
``nugget="pivot"`` emulator on the inputs with one row duplicated.  Each
is computed by ``mogp_tpu`` twice, in a child process with JAX's x64 mode
off (float32) and one with it on (float64), and the script prints the
gaps and ten times them, the limits phase 6 states.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CHECK_I = 4096


def _child(x64):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    sys.path.insert(0, ROOT)
    import mogp_tpu
    from mogp_tpu.uq import validation
    from chip_smoke import make_data, make_thetas, uq_coords, uq_problem, N_OUTPUTS

    x, y = make_data(N_OUTPUTS)
    thetas = make_thetas()
    mgp = mogp_tpu.MultiOutputGP(x, y, nugget="adaptive")
    mgp.fit(thetas)
    obs, xv, yv = uq_problem()
    coords = uq_coords(mogp_tpu.MonteCarloDesign, N_CHECK_I)
    I = mogp_tpu.HistoryMatching(gp=mgp, obs=obs, coords=coords).get_implausibility(0.0, 1)

    z = []
    for e, P in validation.standard_errors(mgp, xv, yv):
        zi = np.empty_like(e)
        zi[P] = e
        z.append(zi)
    piv = validation.pivoted_errors(mgp, xv, yv)
    mahal = validation.mahalanobis(mgp, xv, yv, scaled=True)

    xp, yp = np.vstack([x, x[:1]]), np.append(y[0], y[0][0])
    gpp = mogp_tpu.GaussianProcess(xp, yp, nugget="pivot")
    gpp.fit(thetas[0])
    return {"I": np.asarray(I).tolist(), "z": np.array(z).tolist(),
            "P": [np.asarray(P).tolist() for _, P in piv],
            "rank": [int(np.count_nonzero(e)) for e, _ in piv],
            "mahal": np.asarray(mahal).tolist(), "pivot_logpost": float(gpp.current_logpost),
            "pivot_rank": int(gpp.Kinv.rank)}


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(_child(sys.argv[2] == "64")))
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", MOGP_TPU_DISABLE_PALLAS="1")
    res = {}
    for bits in ("32", "64"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", bits],
                             capture_output=True, text=True, check=True, env=env, cwd=ROOT)
        res[bits] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = res["32"], res["64"]
    I32, I64 = np.array(a["I"]), np.array(b["I"])
    gaps = {
        "I_rel": float(np.max(np.abs(I32 - I64) / np.abs(I64))),
        "z": float(np.max(np.abs(np.array(a["z"]) - np.array(b["z"])))),
        "mahal_scaled": float(np.max(np.abs(np.array(a["mahal"]) - np.array(b["mahal"])))),
        "pivot_logpost_rel": abs(a["pivot_logpost"] - b["pivot_logpost"]) / abs(b["pivot_logpost"]),
    }
    same_P = sum(pa == pb for pa, pb in zip(a["P"], b["P"]))
    print("mogp_tpu float32 vs float64 on the CPU, phase 6's problem:")
    print("  gaps:", json.dumps(gaps))
    print("  limits (ten times):", json.dumps({k: 10 * v for k, v in gaps.items()}))
    print("  pivoted errors: outputs with the same permutation {} of {}; ranks float32 {}..{}, "
          "float64 {}..{}; pivot emulator rank {} / {}, log posterior {} / {}".format(
              same_P, len(a["P"]), min(a["rank"]), max(a["rank"]), min(b["rank"]), max(b["rank"]),
              a["pivot_rank"], b["pivot_rank"], a["pivot_logpost"], b["pivot_logpost"]))
    print("  I range float64: {} .. {}; scaled Mahalanobis range {} .. {}".format(
        I64.min(), I64.max(), min(b["mahal"]), max(b["mahal"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
