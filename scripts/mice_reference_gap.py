#!/usr/bin/env python3
"""mogp_tpu's own float32-vs-float64 gaps on the CPU for the MICE quantities
that ``chip_smoke.py`` phase 8 holds the port to.

Run from the root of a checkout (JAX on the CPU, no card needed, a few
minutes):

    python3 scripts/mice_reference_gap.py

The states are phase 8's configurations, run by ``mogp_tpu`` in float64 in
a child process:

* 8a's ``DeviceMICEDesign`` (``chip_smoke.mice_device_design``) with one
  block of 4096 candidates in place of 10^5, through its last acquisition
  step: the 23 observed points, that step's candidates and its fitted raw
  hyperparameters;
* 8c's ``MICEDesign`` (``chip_smoke.mice_host_design``) through its last
  step: the observed points, the standardized targets, the 50 candidates
  and the fitted hyperparameters.

Then ``mogp_tpu`` evaluates, in a child with JAX's x64 mode off (float32)
and one with it on (float64), at those hyperparameters:

* the masked negative log posterior on the one-rung ("single") ladder the
  fit follows (relative gap);
* the score step on the block of 4096 candidates: the base GP's variances
  (``unc1``, the largest absolute gap over sigma2: near the data they are
  ~0, where float32 keeps no relative digits), the candidate GP's
  leave-one-out variances (``unc2``, the largest relative gap), computed as
  the port computes them, ``1 / [Q^-1]_ii`` less the rung's jitter, from
  ``mogp_tpu``'s factor of ``Q`` and a lower solve of the identity, and
  the means (the largest absolute gap, standardized units).  The scores
  ``unc1 / unc2`` carry both parts' errors: the script prints the largest
  ratio of a score's gap to ``g1 sigma2 / unc2 + g2 s`` (``g1``, ``g2`` the
  two gaps; the first-order propagation phase 8b holds each score to, at
  ten times the gaps) and the regret of the float32 argmax under the
  float64 scores;
* 8c's ``MICEFastGP.fast_predict_all`` (the same way) and the base GP's
  predictive variance at the candidates (the largest relative gaps).

It also prints the gaps of ``mogp_tpu``'s own blockwise sum over ``L^-1
[C | I]`` (its ``_mice_score_step`` and ``fast_predict_all``): the same
function, which in float32 subtracts terms of ``cov^2 / nugget`` to leave
~``nugget`` at the candidate GP's nugget floor, and so gives no limit.

The adaptive jitter is a rung of a ladder, and the two types may take
different rungs; the float32 child's realized base nugget and the candidate
block's jitter are handed to the float64 child (as a fixed nugget and an
added candidate nugget), so the gaps are rounding only, as phase 8 holds the
card at its own rungs.  The script prints the gaps and ten times them, the
limits phase 8 states.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(x64):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    sys.path.insert(0, ROOT)


def _state():
    _jax(True)
    import mogp_tpu
    from chip_smoke import MICE_BLOCK, MICE_HOST_SAMPLES, MICE_SAMPLES, mice_device_design, \
        mice_host_design

    md = mice_device_design(mogp_tpu, n_cand=MICE_BLOCK)
    for _ in range(MICE_SAMPLES - 1):
        md.run_next_point()
    md._generate_candidates()
    md._eval_metric()
    targets = (md.targets - md._t_mean) / md._t_std

    mh = mice_host_design(mogp_tpu)
    for _ in range(MICE_HOST_SAMPLES - 1):
        mh.run_next_point()
    mh._generate_candidates()
    mh._eval_metric()
    return {"inputs": md.inputs.tolist(), "targets": targets.tolist(),
            "cands": md.candidates.tolist(), "theta": md.get_current_theta().tolist(),
            "host_inputs": np.asarray(mh.gp.inputs).tolist(),
            "host_targets": np.asarray(mh.gp.targets).tolist(),
            "host_cands": mh.candidates.tolist(),
            "host_theta": np.asarray(mh.gp.theta.get_data()).tolist()}


def _evaluate(x64, state, pins):
    _jax(x64)
    import jax.numpy as jnp
    import mogp_tpu
    from chip_smoke import MICE_SAMPLES, MICE_INIT
    from jax.scipy.linalg import solve_triangular
    from mogp_tpu.models.gp import make_gp_data
    from mogp_tpu.models.priors import GPPriors
    from mogp_tpu.ops.cholesky import cholesky_factor, jit_cholesky
    from mogp_tpu.ops.kernels import get_kernel
    from mogp_tpu.uq import mice_device as jmd

    dtype = jnp.float64 if x64 else jnp.float32
    eps32 = float(np.finfo(np.float32).eps)
    kernel = get_kernel("SquaredExponential")
    x, y = np.array(state["inputs"]), np.array(state["targets"])
    n_obs, n_max, D = len(x), MICE_INIT + MICE_SAMPLES, x.shape[1]
    raw = jnp.asarray(state["theta"], dtype=dtype)
    sigma2 = float(np.exp(state["theta"][D]))
    x_buf = np.tile(x[:1], (n_max, 1))
    x_buf[:n_obs] = x
    y_buf = np.zeros(n_max)
    y_buf[:n_obs] = y
    mask = jnp.asarray(np.arange(n_max) < n_obs, dtype=dtype)
    priors = GPPriors.default_priors(x, D, nugget_type="adaptive")
    data = make_gp_data(x_buf, y_buf, np.zeros((n_max, 0)), priors, dtype=dtype)
    nlp = float(jmd.masked_gp_nlp(raw, data, mask, kernel, "adaptive", True,
                                  sparse_ladder="single"))

    cands = jnp.asarray(state["cands"], dtype=dtype)
    B = cands.shape[0]
    eye = jnp.eye(B, dtype=dtype)
    C = sigma2 * kernel.kernel_f(cands, cands, raw[:D])
    if pins is None:  # the float32 child: its own rungs
        K = sigma2 * kernel.kernel_f(data.inputs, data.inputs, raw[:D])
        Kt = mask[:, None] * mask[None, :] * K + jnp.diag(1.0 - mask)
        _, nug = cholesky_factor(Kt, 0.0, "adaptive", jitter_mask=mask)
        fast = max(float(nug), 1e3 * eps32 * sigma2)
        _, jit = jit_cholesky(C + fast * eye, jitter_mask=jnp.ones(B, dtype=dtype))
        pins = {"nugget": float(nug), "fast": fast, "jitter": float(jit)}
    data_f = make_gp_data(x_buf, y_buf, np.zeros((n_max, 0)), priors,
                          nugget_value=pins["nugget"], dtype=dtype)
    scores, mu = jmd._mice_score_step(raw, data_f, mask, cands[None], jnp.ones((1, B), dtype),
                                      jnp.asarray(pins["fast"] + pins["jitter"], dtype),
                                      jnp.asarray(0.0, dtype), kernel, "fixed", True)
    # the same criterion with the candidate variances as the Schur
    # complements 1 / [Q^-1]_ii less the rung's jitter, from mogp_tpu's own
    # factor of Q and a lower solve of the identity
    gp = mogp_tpu.GaussianProcess(x, y, nugget=pins["nugget"])
    gp.fit(np.asarray(state["theta"]))
    unc1 = np.asarray(gp.predict(np.asarray(cands), unc=True)[1], np.float64)
    L, jit = jit_cholesky(C + (pins["fast"] + pins["jitter"]) * eye,
                          jitter_mask=jnp.ones(B, dtype=dtype))
    schur = 1.0 / np.asarray(jnp.sum(solve_triangular(L.L, eye, lower=True) ** 2, axis=0),
                             np.float64)
    unc2 = np.maximum(schur - pins["jitter"] - float(jit), 0.0)
    scores_schur = unc1 / np.maximum(unc2, np.finfo(np.float32).tiny)

    hx, hy = np.array(state["host_inputs"]), np.array(state["host_targets"])
    hc, ht = np.array(state["host_cands"]), np.array(state["host_theta"])
    if "host_nugget" not in pins:
        gp = mogp_tpu.GaussianProcess(hx, hy, nugget="adaptive")
        gp.fit(ht)
        pins["host_nugget"] = float(gp.nugget)
        pins["host_fast"] = max(float(gp.nugget), 1e3 * eps32 * float(gp.theta.cov))
    gp = mogp_tpu.GaussianProcess(hx, hy, nugget=pins["host_nugget"])
    gp.fit(ht)
    host_unc1 = gp.predict(hc, unc=True)[1]
    fast_gp = mogp_tpu.MICEFastGP(hc, np.ones(len(hc)), nugget=pins["host_fast"])
    fast_gp.fit(ht[: fast_gp.n_params])
    Lf = fast_gp._artifacts.Kinv.L
    fast_schur = 1.0 / np.asarray(jnp.sum(solve_triangular(
        Lf, jnp.eye(Lf.shape[0], dtype=dtype), lower=True) ** 2, axis=0), np.float64)
    return {"nlp": nlp, "scores_blockwise": np.asarray(scores, np.float64).tolist(),
            "scores": scores_schur.tolist(), "mu": np.asarray(mu, np.float64).tolist(),
            "unc1_block": unc1.tolist(), "unc2_block": unc2.tolist(),
            "unc1": np.asarray(host_unc1, np.float64).tolist(),
            "unc2_blockwise": np.asarray(fast_gp.fast_predict_all(), np.float64).tolist(),
            "unc2": fast_schur.tolist(), "pins": pins}


def _run(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MOGP_TPU_DISABLE_PALLAS="1")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *args], capture_output=True,
                         text=True, check=True, env=env, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "--state":
        print(json.dumps(_state()))
        return 0
    if len(sys.argv) >= 2 and sys.argv[1] == "--evaluate":
        with open(sys.argv[3]) as f:
            blob = json.load(f)
        print(json.dumps(_evaluate(sys.argv[2] == "64", blob["state"], blob.get("pins"))))
        return 0

    state = _run("--state")
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"state": state}, f)
    try:
        a = _run("--evaluate", "32", f.name)
        with open(f.name, "w") as g:
            json.dump({"state": state, "pins": a["pins"]}, g)
        b = _run("--evaluate", "64", f.name)
    finally:
        os.remove(f.name)
    def rel(key):
        u, v = np.array(a[key]), np.array(b[key])
        return float(np.max(np.abs(u - v) / np.abs(v)))

    sigma2 = float(np.exp(state["theta"][len(state["inputs"][0])]))
    s32, s64 = np.array(a["scores"]), np.array(b["scores"])
    u2 = np.array(b["unc2_block"])
    gaps = {
        "nlp_rel": abs(a["nlp"] - b["nlp"]) / abs(b["nlp"]),
        "unc1_of_sigma2": float(np.max(np.abs(np.array(a["unc1_block"])
                                              - np.array(b["unc1_block"])))) / sigma2,
        "unc2_rel": rel("unc2_block"),
        "mu_abs": float(np.max(np.abs(np.array(a["mu"]) - np.array(b["mu"])))),
        "fast_predict_rel": rel("unc2"),
        "unc1_rel": rel("unc1"),
    }
    # the scores s = unc1 / unc2 carry both parts' errors: to first order
    # |ds| <= |d unc1| / unc2 + s |d unc2| / unc2
    bound = gaps["unc1_of_sigma2"] * sigma2 / u2 + gaps["unc2_rel"] * s64
    use = float(np.max(np.abs(s32 - s64) / bound))
    regret = float((s64.max() - s64[int(np.argmax(s32))]) / s64.max())
    blockwise = {"scores_of_max": float(np.max(np.abs(np.array(a["scores_blockwise"]) - s64))
                                        / s64.max()),
                 "fast_predict_rel": rel("unc2_blockwise")}
    for key in ("scores_blockwise", "unc2_blockwise"):
        r = np.abs(np.array(a[key]) - np.array(b[key])) / np.abs(np.array(b[key]))
        blockwise[key + "_median_rel"] = float(np.median(r))
        blockwise[key + "_share_off_by_half"] = float(np.mean(r > 0.5))
    print("8a state: {} observed points, theta {}; float32 rungs {}".format(
        len(state["inputs"]), state["theta"], a["pins"]))
    print("8c state: {} observed points, theta {}".format(len(state["host_inputs"]),
                                                          state["host_theta"]))
    print("float64: masked NLP {}; scores {} to {} (argmax {}), mu {} to {}".format(
        b["nlp"], s64.min(), s64.max(), int(np.argmax(s64)), min(b["mu"]), max(b["mu"])))
    print("the block's scores: largest difference over the largest score {}, largest over "
          "the bound propagated from the gaps of unc1 and unc2 {}; regret of the float32 "
          "argmax under the float64 scores {}".format(
              float(np.max(np.abs(s32 - s64)) / s64.max()), use, regret))
    print("the block's base variance: largest rel gap {} (where it is ~0 near the data)".format(
        rel("unc1_block")))
    print("mogp_tpu's own blockwise LOO sum (what its score step and MICEFastGP compute):",
          json.dumps(blockwise))
    print("gaps:", json.dumps(gaps))
    print("limits (10x):", json.dumps({k: 10 * v for k, v in gaps.items()}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
