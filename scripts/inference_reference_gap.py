#!/usr/bin/env python3
"""mogp_tpu's own float32-vs-float64 gaps on the CPU for the NUTS potential
and the posterior predictive that ``chip_smoke.py`` phases 7a and 7e hold
the port to.

Run from the root of a checkout (JAX on the CPU, no card needed):

    python3 scripts/inference_reference_gap.py

The problem is phase 7a's, ``bench.py``'s NUTS problem (n = 210, D = 14,
``nugget="fit"``), MAP-fit as ``bench.py`` fits it.  A float64 child runs
``mogp_tpu``'s ``sample_GP_MCMC`` from the MAP (4 chains, 100 warmup, 16
samples) for 64 posterior samples.  Then ``mogp_tpu`` evaluates, in a
child with JAX's x64 mode off (float32) and one with it on (float64),
``gp_nlp`` on the one fixed jitter rung and its gradient at those samples,
and ``predict_MCMC`` of the samples at phase 7e's queries
(``chip_smoke.predict_queries``: training inputs moved by about one
posterior correlation length).  The script prints the gaps and ten times
them, the limits phase 7a states:

* the potential's relative difference, the largest over the samples;
* per gradient component, the largest difference over the samples over
  the component's root-mean-square over the samples (the gradient at a
  single sample can be near zero, so it is not the scale);
* the predictive mean's and variance's largest absolute differences.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gp(mogp_tpu):
    from chip_smoke import nuts_problem

    x, y = nuts_problem()
    return mogp_tpu.GaussianProcess(x, y, nugget="fit")


def _points():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    import mogp_tpu
    from mogp_tpu.models.inference import sample_GP_MCMC

    np.random.seed(2)
    gp = mogp_tpu.fit_GP_MAP(_gp(mogp_tpu), n_tries=4, maxiter=50)
    res = sample_GP_MCMC(gp, n_samples=16, n_warmup=100, n_chains=4, seed=1,
                         theta0=gp.theta.get_data())
    return {"points": res.samples.reshape(-1, gp.n_params).tolist(),
            "theta": gp.theta.get_data().tolist()}


def _evaluate(x64, points):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    import mogp_tpu
    from chip_smoke import N_CHECK, nuts_problem, predict_queries
    from mogp_tpu.models.fitting import _OPT_LADDER
    from mogp_tpu.models.gp import gp_nlp
    from mogp_tpu.models.inference import predict_MCMC

    gp = _gp(mogp_tpu)
    pg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda r: gp_nlp(r, gp._data, gp.kernel, gp.nugget_type, sparse_ladder=_OPT_LADDER))))
    u, g = pg(jnp.asarray(points, dtype=gp._data.inputs.dtype))
    mean, var = predict_MCMC(gp, np.asarray(points),
                             predict_queries(nuts_problem()[0], points, N_CHECK))
    return {"u": np.asarray(u, np.float64).tolist(), "g": np.asarray(g, np.float64).tolist(),
            "mean": np.asarray(mean, np.float64).tolist(),
            "var": np.asarray(var, np.float64).tolist()}


def _run(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MOGP_TPU_DISABLE_PALLAS="1")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *args], capture_output=True,
                         text=True, check=True, env=env, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "--points":
        print(json.dumps(_points()))
        return 0
    if len(sys.argv) >= 2 and sys.argv[1] == "--evaluate":
        with open(sys.argv[3]) as f:
            points = json.load(f)["points"]
        print(json.dumps(_evaluate(sys.argv[2] == "64", points)))
        return 0
    import tempfile

    pts = _run("--points")
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(pts, f)
    try:
        a, b = (_run("--evaluate", bits, f.name) for bits in ("32", "64"))
    finally:
        os.remove(f.name)
    u32, u64 = np.array(a["u"]), np.array(b["u"])
    g32, g64 = np.array(a["g"]), np.array(b["g"])
    gaps = {
        "value_rel": float(np.max(np.abs(u32 - u64) / np.abs(u64))),
        "grad_rel": (np.max(np.abs(g32 - g64), axis=0)
                     / np.sqrt(np.mean(g64**2, axis=0))).tolist(),
        "mean": float(np.max(np.abs(np.array(a["mean"]) - np.array(b["mean"])))),
        "var": float(np.max(np.abs(np.array(a["var"]) - np.array(b["var"])))),
    }
    print("MAP theta:", pts["theta"])
    print("potential at the 64 samples: {} to {}".format(u64.min(), u64.max()))
    print("gaps:", json.dumps(gaps))
    print("limits (10x):", json.dumps({k: (10 * np.asarray(v)).tolist()
                                       for k, v in gaps.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
