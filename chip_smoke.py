#!/usr/bin/env python3
"""Bring-up check of mogp_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. The card's name and power limit (``nvidia-smi``), and the build of the
   CUDA kernels from ``mogp_tpu_torch/csrc`` (``nvcc``, at first use).
2. Every kernel against its plain PyTorch version on the card, at the
   bring-up shapes and at the shapes the main path gives it, in float32
   and float64, then timed against the plain version and, for the
   Cholesky kernels, against ``torch.linalg.cholesky_ex`` (in turns:
   plain, library, kernel, kernel, library, plain), printing the ratio
   kernel / ``cholesky_ex`` and the share of the bound (``bound_ms``): K1,
   the fused kernel-matrix build (2), at the headline emulator's former
   predict tile (64, 210, 4864, 14) and at the tile phase 5 gives it; the
   fused prediction, K1 redesigned so that K* stays on chip (2d), against
   the plain version in float64 (the kernel within 2x the float32 plain
   version's error) at the bring-up shapes, the headline tile and the
   route's bounds, M = 0 and 15, with ``unc`` on and off, and at the main
   path's own tile on a sample of its columns; timed against the plain
   version and the unfused chain it replaces (K1, the products, cuBLAS's
   triangular solve, the sums); K2, the batched Cholesky (2b), up to its
   shared-memory bound (n = 340 in float32, 240 in float64), every call
   launching K2 once; K3-K5, the blocked Cholesky variants v1-v3 (2c), above
   that bound up to n = 8192 (the large-n fit's (1, 4096) and (1, 8192),
   its MAP fit's (4, 4096) lanes, its float64 fit's (1, 4096), phase 8's
   25 candidate blocks (25, 4096)), with a
   non-PD lane and a lane whose pivot fails mid-matrix (its ``info`` the
   failing column), and on the ill-conditioned SqExp K of the n = 4096
   problem at its realized jitter; every call one panel loop.
3. The serving path at full width: a 64-output ``MultiOutputGP`` with
   n = 210 training points in D = 14 dimensions (``nugget="adaptive"``,
   float32 on the card) fit at seeded hyperparameters, then asked for
   means and variances at 10^6 seeded query points through the fused
   kernel (no K1 launch, so no (L, n, tile) K* on the device); the peak
   device memory is printed.  The first 4096
   queries are held against the same problem run by the port on the CPU in
   float64.
4. The MAP fit at full width, with the protocol of ``bench.py:107-128``:
   ``fit_GP_MAP`` of the same 64 outputs, 15 restarts each, ``maxiter=50``
   (race on, one-rung trajectory ladder), float32 on the card; a warm-up
   fit from seed 0, then the timed refit from seed 1.  All 64 outputs must
   fit; the winners of the first 4 outputs, re-evaluated in float64, must
   be within 0.25 nats on average of the same seeded fit run by the port
   on the CPU in float64.
5. The large-n GP (``benchmarks/benchmark_large_n.py``, ``bench.py``'s
   ``large_n`` metric): one ``GaussianProcess`` (D = 8,
   ``nugget="adaptive"``, float32), through ``tools/large_n.py`` at n =
   4096 and 8192 (fit time, TFLOP/s, one value + gradient, one route
   launch per progressive ladder rung), ``fit_GP_MAP`` with 4 restarts and
   ``maxiter=20``, and a prediction at 10^5 seeded queries (n above the
   fused route's bound: K1, then the solves).  The float32 log
   posterior must be within 1e-3 of the port's on the CPU in float64 at the
   card's realized nugget, and the same fit in float64 on the card within
   1e-9 of the CPU's.  No CUDA tensor may reach ``torch.linalg.cholesky_ex``
   in this phase.

6. The UQ workflow at full width, on phase 3's configuration:
   ``MaxiMinLHC`` of 210 samples in 14 parameters from 1000 candidates
   scored on the card (the chosen one, re-scored in float64, must be the
   best to 1e-5); a ``HistoryMatching`` sweep of 10^7 seeded Monte Carlo
   coords (rank 1) through the device sweep (the fused kernel, no K1),
   with its wall time, device time and peak memory, held against the host
   path on the card on the first 2^20 coords and against float64 on the
   CPU on the first 4096, NROY and RO partitioning the coords; validation
   of all 64 outputs at 210 seeded points (standard and pivoted errors,
   the scaled Mahalanobis distances; K1 launches) against float64 on the
   CPU; a ``nugget="pivot"`` emulator with one input duplicated, fit and
   predicted on the unfused route (no fused launch), its log posterior
   within 1e-3 of float64 on the CPU.

7. The inference workflow at full width (float32 unless it says
   otherwise): 7a ``sample_GP_MCMC`` on ``bench.py``'s NUTS problem (n =
   210, D = 14, ``nugget="fit"``, MAP as ``bench.py`` fits it), 64 chains,
   200 warmup + 200 samples after a short warm-up run, printing min-ESS/s,
   leapfrogs per transition and per second, lane utilization, host syncs
   per transition, divergences, acceptance, R-hat and K2's launches; R-hat
   < 1.1 and at most 1% divergent transitions; the idle share of another,
   short run (seed 2, trees of at most 63 leapfrogs), read from its 3
   sampling transitions after its warmup, with K2's count there equal to
   the profiler's count of K2 kernels; the float32 potential and each
   component of its gradient at the last sample of every chain against
   float64 on the CPU (ten times ``mogp_tpu``'s own float32 gap,
   ``scripts/inference_reference_gap.py``);
   7d ``fit_GP_VI`` (400 steps) on the same GP, a finite mean and a rising
   ELBO; 7e ``predict_MCMC`` of chains 0-1 thinned by 5 (80 lanes) at 4096
   queries near the training inputs (``predict_queries``) through K2 and
   the fused kernel, against float64 on the CPU within phase 3's limits; 7b ``sample_MOGP_MCMC`` of phase 4's MAP fit,
   4 chains per output (256 lanes), 100 + 100, R-hat < 1.2 on at least 90%
   of the outputs, and the idle share as in 7a; 7c the quadrature oracle of
   ``tests/test_inference.py:164-217`` in float64 on the card (64 chains,
   200 + 150), posterior means within 4 MCSE of the quadrature (computed
   by the port on the CPU); 7f ``smc_history_match`` on phase 6's emulator
   and observations, 65,536 particles, 10 stages, 5 MH steps, rank 1, the
   final particles' I against float64 on the CPU (phase 6's limit) and the
   NROY count, and a ``standardize=True`` copy's I against the host path of
   ``HistoryMatching`` on 4096 particles.

8. MICE sequential design (float32): 8a ``DeviceMICEDesign`` at the
   reference's ``device_scale`` width (``benchmarks/benchmark_MICE.py:70-103``:
   Branin, seed 8213, 16 initial points, 8 acquisitions over 10^5
   candidates in 25 blocks of 4096, 8 restarts x ``maxiter=60``,
   ``nugget="adaptive"``), each step's wall time split into the fit and
   the score step, ``mice_seconds_per_step`` (the warm median) and the peak
   device memory; the chosen points inside the bounds and all 24 targets
   finite; 8b the last step at the card's theta and jitter rungs against
   float64 on the CPU: the masked NLP, the scores and means of block 0 and
   of the block holding the card's argmax, and the argmax's regret under
   the float64 scores; 8c ``MICEDesign`` (Branin, 10 initial points, 4
   acquisitions over 50 candidates), at each step ``fast_predict_all`` and
   the base GP's variances against float64 on the CPU at the card's theta
   and nuggets.  The limits are ten times ``mogp_tpu``'s own float32 gaps
   (``scripts/mice_reference_gap.py``).  No CUDA tensor may reach
   ``torch.linalg.cholesky_ex`` in 8a or 8c.

9. gKDR and the kernel derivatives (their float64 CPU references run in
   three worker processes meanwhile, and are checked after phase 10): 9a
   ``gKDR`` at the repo's calibration demo's width
   (``demos/calibration_at_scale.py:38-97``: 300 ``LatinHypercubeDesign``
   inputs in 20 dimensions, a 3-dimensional active subspace, seed 1) in
   float64 on the card, its warm wall (the median of 3), its parts by CUDA
   events (the two K1 Grams, the factor on the blocked route, the solves,
   the contraction, ``eigh``), the subspace overlap; the eigenvalues within
   1e-9 (relative to the largest) and the rank-3 projector within 1e-8 of
   float64 on the CPU; then ``fit_GP_MAP`` of the 100 outputs (15
   restarts, ``maxiter=50``, float32, 1500 lanes on K2) on the reduced
   inputs, every output fit and phase 4's quality gate; 9b
   ``benchmarks/benchmark_kdr_GP.py``'s loss curve (N = M = 100, 5 folds,
   K = 1, 2, 4, a 3-restart GP fit per fold on the card; gKDR at N = 80
   on K2 in float64), argmin K = 1 and each loss within ten times
   ``mogp_tpu``'s own float32 gap of float64 on the CPU; 9c
   ``kernel_deriv`` and ``kernel_hessian`` of the five kernels at phase
   3's inputs ((210, 210), 14 parameters) in float32 against float64 on
   the CPU, within ten times ``mogp_tpu``'s float32 gap
   (``scripts/gkdr_reference_gap.py``), finite and exactly 0 at zero
   distance.
10. The multi-device layer on one card: 10a ``auto_mesh()`` (shape
    ``{"outputs": 1}``), ``fit_GP_MAP(mesh=)`` at phase 4's configuration
    held to phase 4's gate, the outputs whose theta is bit-identical to
    phase 4's counted; 10b ``DeviceMesh([cuda:0] * 4)``, whose shards run
    in turn, through every path's split and merge: the fit as in 10a;
    ``HistoryMatching(mesh=)`` over phase 6's 10^7 coords (I within 1e-6
    of phase 6's, the same NROY set); ``smc_history_match(mesh=)`` at 7f's
    configuration and seed (particles and I within 1e-6 of 7f's);
    ``sample_GP_MCMC(mesh=)`` on 7a's GP, 8 chains, 20 + 20, trees of at
    most 63 leapfrogs, against the unsharded run (finite; each pooled mean
    within 4 combined Monte Carlo standard errors); 2 steps of 8a through
    ``DeviceMICEDesign(mesh=)``, the same points as 8a's first two.  No
    CUDA tensor may reach ``torch.linalg.cholesky_ex`` in 9a, 9b or 10's
    fit and MICE.  One card measures no speedup from several.
11. Several processes on the card: two worker processes (``python3
    chip_smoke.py --fit-worker RANK PORT 2``, started by
    ``mogp_tpu_torch/tools/workers.py``), joined by ``init_distributed`` on
    localhost (gloo), each on ``cuda:0``; each runs phase 4's warm-up fit
    and its timed fit over ``auto_mesh()`` (``[cuda:0] * 2``, one entry a
    process), fitting 32 of the 64 outputs and receiving the rest through
    the fit's gathers.  Every theta on both processes must be bit-identical
    to phase 4's, both must hold all 64 outputs, K2 must launch in each
    (counted per process), and process 1's ``predict`` of phase 3's first
    4096 queries must equal phase 4's emulator's on the card bit for bit.
    Then each process runs ``sample_MOGP_MCMC`` of its fit over the same
    mesh (2 chains an output, 10 + 10, trees of at most 31 leapfrogs),
    whose chains must equal, bit for bit, the same run in this process
    over ``DeviceMesh([cuda:0] * 2)`` (the same shards), with K2 launched
    in each process.  It prints each process's fit and MCMC walls, phases
    and gathers, and the phase's wall.  A worker that fails, or outlasts
    300 s, ends both and fails the phase.

Around each of phases 3, 4, 5, 6's sweep, 7a, 7b, 7e, 7f, 8a and 8c the
kernels' launch counters are zeroed just before and read just after;
every kernel of the path must have launched (the fused prediction in 3,
6, 7e, 7f and 8a, K2 in 4, 7a, 7b, 7e, 8a and 8c, K1 and the routed
blocked variant in 5, the routed blocked variant in 8a, where the other
two must not launch), and around 9a's gKDR and fit, 9b and each path of
10 (K1 twice and the blocked route once per gKDR, K2 in 9a's fit, 9b and
10's fits and NUTS, the fused kernel in 10b's sweep and SMC, K1, the
fused kernel and the routed blocked variant in 10b's MICE), and in each
process of 11 around its timed fit and its MCMC (K2).  On the card
the NUTS and VI potential is replayed from a CUDA
graph; K2's wrapper counts the launches of each replay
(``ops/cholesky_batched.py::replay``).  The
blocked variants the route does not take are checked and timed in 2c and
listed with the launches they made in 5 (none) and ``"routed": false``.
The last three lines of standard output are a JSON object describing each
kernel (K1, the fused prediction, K2, K3-K5; K2's launches per leapfrog in
7a and 7b, the fused kernel's per SMC stage in 7f, each kernel's per MICE
step in 8a, K3-K5 also at (25, 4096); each kernel's launches per gKDR
and in 9a's fit and 9b, under the mesh in 10a and 10b, and K2's in each
process's fit and MCMC of 11), the
``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits with a non-zero code and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

N_POINTS, N_DIM, N_OUTPUTS, N_QUERIES = 210, 14, 64, 10**6
N_CHECK = 4096
# the headline emulator's predict tile before the fused kernel (PR 1-7):
# where K1 has been timed against its bound since PR 1, and the fused
# kernel against the unfused chain
K1_SHAPE = (N_OUTPUTS, N_POINTS, 4864, N_DIM)

# phase 2: kernel vs plain version on the same inputs.  float32: the
# kernel's difference form and the plain matmul form round differently
# (as tests/test_pallas.py:25 allows the Pallas kernel); float64: a few
# ulps of |z|^2.
KERNEL_TOL = {"float32": (2e-5, 2e-6), "float64": (1e-12, 1e-13)}

# phase 3: float32 on the card vs float64 on the CPU, on the first 4096
# queries.  Sized from the reference: mogp_tpu on a CPU, same problem,
# float32 vs float64, differs by at most 5.6e-5 in the means (targets of
# order 1-4), 4.1e-6 in the variances and 2.7e-6 (relative) in the log
# posteriors.  The limits are ten times that.
SLICE_TOL = {"mean": 5.6e-4, "unc": 4.1e-5, "logpost_rel": 2.7e-5}

# phase 2b: max |L - L_plain| / max |L_plain| on B B^T + n I (condition
# ~5).  Both are float Cholesky factorizations in other summation orders:
# ~sqrt(n) eps of |L|, about 2e-6 in float32 at n = 1000 (9.1e-7 measured
# at n = 340 on an H100); the limits leave ten times that.
CHOL_TOL = {"float32": 1e-5, "float64": 1e-12}

# The card's peaks for the bound of each kernel (the least time the card
# could take for the same work: the larger of its bytes over the memory rate
# and its flops over the peak rate for their type), from the H100 SXM data
# sheet: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 (FMA) and in float64
# (DMMA, the FP64 tensor cores).
PEAK_BYTES_PER_S, PEAK_FLOPS = 3.35e12, 67e12


def bound_ms(n_bytes, flops):
    """``(ms, "bytes" or "operations")``: the larger of the two times."""
    t_bytes, t_flops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def chol_bound_ms(B, n, dtype):
    """The bound of a batched Cholesky of ``(B, n, n)``: the lower triangle
    read, the whole factor written, ``n^3 / 3`` flops per matrix."""
    size = 4 if str(dtype).endswith("float32") else 8
    return bound_ms(B * (n * (n + 1) // 2 + n * n) * size, B * n**3 / 3)


# phase 4: the MAP fit (bench.py:107-128) and its quality gate, the mean
# NLP gap of the JAX package's own test (tests/test_fitting.py:144-146)
N_TRIES, MAXITER, N_QUALITY, NLP_GAP = 15, 50, 4, 0.25


def make_data(n_outputs, seed=1234):
    """Synthetic tsunami-shaped data (the generator of bench.py:67-77)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    w = rng.randn(n_outputs, N_DIM)
    phase = rng.uniform(0, 2 * np.pi, size=n_outputs)
    targets = (
        np.sin(inputs @ w.T + phase)
        + 0.3 * (inputs**2) @ np.abs(w).T
        + 0.01 * rng.randn(N_POINTS, n_outputs)
    )
    return inputs, targets.T.copy()


def make_thetas(seed=0):
    """Raw hyperparameters: correlation raws in U(-1, 1), covariance raw in
    U(-0.5, 0.5)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(-1, 1, size=(N_OUTPUTS, N_DIM)),
         rng.uniform(-0.5, 0.5, size=(N_OUTPUTS, 1))],
        axis=1,
    )


# phase 6: the UQ workflow at full width on the headline configuration.
# The design: MaxiMinLHC of N_POINTS samples in N_DIM parameters from
# N_DESIGN_TRIES candidates; the sweep: N_SWEEP Monte Carlo coords
# (rank 1, no discrepancy), checked against the host path on the first
# N_SWEEP_HOST and against the CPU in float64 on the first N_CHECK; the
# validation: N_VALID seeded points.
N_DESIGN_TRIES, N_SWEEP, N_SWEEP_HOST, N_VALID = 1000, 10**7, 2**20, 210
# the chosen design's float64 score against the best float64 score of the
# same candidates (float32 scores round at ~1e-7 of the distances)
DESIGN_RTOL = 1e-5
# the device sweep (float32 I on the card) against the host path (float64
# I from the same float32 predictions): four float32 roundings of I (five
# for standardized emulators, whose observations the sweep maps into their
# units and rounds to float32)
SWEEP_HOST_RTOL = 1e-6
# float32 on the card vs float64 on the CPU, ten times mogp_tpu's own
# float32-vs-float64 gap on a CPU for the same quantities
# (scripts/uq_reference_gap.py: 2.96e-5, 1.51e-4, 1.57e-4): I on the
# first N_CHECK coords (relative, I from 1.8 to 10.9); the z-scores of the
# standard errors (absolute); the scaled Mahalanobis distances (absolute,
# from -6.5 to 13.8).  The pivoted errors' permutations differ between
# the two types for 2 of 64 outputs in mogp_tpu too, so they are held
# through the Mahalanobis distances, which do not depend on the order.
UQ_TOL = {"I_rel": 3.0e-4, "z": 1.5e-3, "mahal_scaled": 1.6e-3}
# the pivot-nugget emulator's log posterior, float32 card vs float64 CPU
PIVOT_LOGPOST_RTOL = 1e-3


def simulator(x, n_outputs, seed=1234):
    """The function of ``make_data`` without its noise, at points ``x``
    ``(m, N_DIM)``: ``(n_outputs, m)``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))  # make_data's inputs
    w = rng.randn(n_outputs, N_DIM)
    phase = rng.uniform(0, 2 * np.pi, size=n_outputs)
    return (np.sin(x @ w.T + phase) + 0.3 * (x**2) @ np.abs(w).T).T.copy()


def uq_problem(seed=5):
    """Phase 6's observations (the simulator at a seeded point, seeded
    variances) and validation set (seeded points, simulator targets)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x_star = rng.uniform(size=(1, N_DIM))
    obs = [simulator(x_star, N_OUTPUTS)[:, 0], rng.uniform(0.01, 0.05, size=N_OUTPUTS)]
    xv = rng.uniform(size=(N_VALID, N_DIM))
    return obs, xv, simulator(xv, N_OUTPUTS)


def uq_coords(design_cls, n, seed=6):
    """``n`` Monte Carlo coords from ``design_cls(N_DIM)`` (either
    package's ``MonteCarloDesign``), seeded: the first rows of a larger
    draw are a smaller draw."""
    import numpy as np

    np.random.seed(seed)
    return design_cls(N_DIM).sample(n)


# phase 7: the inference workflow at full width.  7a: NUTS on bench.py's
# problem (bench.py:236-300; n = 210, D = 14, nugget="fit"), 64 chains,
# 200 warmup and 200 samples, after a short warm-up run; 7b:
# sample_MOGP_MCMC on phase 4's MAP fit, 4 chains per output (256 lanes),
# 100 + 100; 7c: the quadrature oracle of tests/test_inference.py:164-217 in
# float64 on the card; 7d: fit_GP_VI on 7a's GP; 7e: predict_MCMC of 7a's
# chains 0-1 thinned by 5 (80 lanes) at 4096 queries near the training
# inputs; 7f:
# smc_history_match on phase 6's emulator and observations.
NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES = 64, 200, 200
MOGP_CHAINS, MOGP_WARMUP, MOGP_SAMPLES = 4, 100, 100
ORACLE_CHAINS, ORACLE_WARMUP, ORACLE_SAMPLES = 64, 200, 150
VI_STEPS, PRED_THIN, PRED_CHAINS = 400, 5, 2
SMC_PARTICLES, SMC_STAGES, SMC_MCMC, SMC_STD_CHECK = 65536, 10, 5, 4096
# 7a's gates: R-hat of every parameter, the share of divergent transitions
NUTS_RHAT, NUTS_DIVERGENT = 1.1, 0.01
# 7b's gate: R-hat < MOGP_RHAT on at least MOGP_RHAT_SHARE of the outputs
MOGP_RHAT, MOGP_RHAT_SHARE = 1.2, 0.9
# the idle share: the PROFILE_SAMPLES sampling transitions of a short run
# (trees of at most 2**PROFILE_DEPTH - 1 leapfrogs), timed, then again under
# torch.profiler for the device's busy time (_sampling_busy_share).  The
# profiler records each of the ~400 kernels of a leapfrog, and its Python
# post-processing of a 10 + 10 run took ~2 minutes on an H100 host
PROFILE_WARMUP, PROFILE_SAMPLES, PROFILE_DEPTH = 10, 3, 6
# the share of K2's launches in such a run that the profiler may miss
# (its records once held 188 of 189 on an H100); a counter wrong by one
# launch a replay would be off by as many launches as there are replays
K2_PROFILER_LOSS = 20
# 7a: the card's float32 potential and gradient at 64 recorded samples
# against float64 on the CPU: ten times mogp_tpu's own float32-vs-float64
# gap on a CPU at 64 posterior samples of the same problem
# (scripts/inference_reference_gap.py).  The potential relative (gap
# 7.65e-4).  The gradient per component, as the largest difference over
# the component's root-mean-square over the samples: the 14 correlation
# lengths at ten times the largest of their gaps (5.3e-7 to 1.4e-6), the
# covariance and the nugget each at its own (7.53e-2, 3.7e-6).  The
# covariance's slope is small beside the two ~n/2 terms that cancel in
# it, so float32 leaves it mostly rounding.
POTENTIAL_TOL = {"value_rel": 7.65e-3, "grad_rel": [1.4e-5] * N_DIM + [0.753, 3.71e-5]}
# 7e: phase 3's limits (SLICE_TOL), within ten times mogp_tpu's own gap
# at 64 of its posterior samples and predict_queries (the script
# above: 1.32e-2 in the mean, 1.61e-2 in the variance)
PREDICT_TOL = {"mean": min(SLICE_TOL["mean"], 0.132), "var": min(SLICE_TOL["unc"], 0.161)}


# phase 8: MICE sequential design.  8a: DeviceMICEDesign at full width, the
# reference's device_scale configuration (benchmarks/benchmark_MICE.py:70-103):
# Branin on MICE_BOUNDS from a LatinHypercubeDesign base, seed 8213, 16
# initial points and 8 acquisitions over 10^5 candidates in blocks of 4096
# (25 blocks, padded to 102,400), 8 restarts of at most 60 iterations a step,
# SquaredExponential, nugget="adaptive"; 8c: MICEDesign on Branin, 10
# initial points, 4 acquisitions over 50 candidates
MICE_BOUNDS = [(-5.0, 10.0), (0.0, 15.0)]
MICE_SEED, MICE_INIT, MICE_SAMPLES, MICE_CAND, MICE_BLOCK = 8213, 16, 8, 10**5, 4096
MICE_TRIES, MICE_MAXITER = 8, 60
MICE_HOST_SEED, MICE_HOST_INIT, MICE_HOST_SAMPLES, MICE_HOST_CAND = 74294, 10, 4, 50


def branin(x):
    """The Branin function on MICE_BOUNDS (benchmarks/common.py:15-23)."""
    import numpy as np

    x = np.atleast_2d(x)
    x1, x2 = x[..., 0], x[..., 1]
    b, c, t = 5.1 / (4 * np.pi**2), 5 / np.pi, 1 / (8 * np.pi)
    return (x2 - b * x1**2 + c * x1 - 6.0) ** 2 + 10.0 * (1 - t) * np.cos(x1) + 10.0


def mice_device_design(pkg, n_cand=MICE_CAND, **kw):
    """8a's DeviceMICEDesign of ``pkg`` (mogp_tpu or mogp_tpu_torch), with
    numpy's RNG seeded and its initial design run."""
    import numpy as np

    np.random.seed(MICE_SEED)
    md = pkg.DeviceMICEDesign(pkg.LatinHypercubeDesign(MICE_BOUNDS), lambda x: branin(x)[0],
                              n_samples=MICE_SAMPLES, n_init=MICE_INIT, n_cand=n_cand,
                              cand_block=MICE_BLOCK, n_tries=MICE_TRIES, maxiter=MICE_MAXITER,
                              **kw)
    md.run_initial_design()
    return md


def mice_host_design(pkg, **kw):
    """8c's MICEDesign of ``pkg``, seeded, its initial design run."""
    import numpy as np

    np.random.seed(MICE_HOST_SEED)
    md = pkg.MICEDesign(pkg.LatinHypercubeDesign(MICE_BOUNDS), lambda x: branin(x)[0],
                        n_samples=MICE_HOST_SAMPLES, n_init=MICE_HOST_INIT,
                        n_cand=MICE_HOST_CAND, **kw)
    md.run_initial_design()
    return md


# phase 9: gKDR and the kernel derivatives.  9a: the repo's calibration
# demo (demos/calibration_at_scale.py:38-97): 300 LatinHypercubeDesign
# inputs in 20 dimensions, 100 outputs driven by a 3-dimensional active
# subspace, seed 1; gKDR(X, Y[0], K=3), then the 100-output MAP fit on the
# reduced inputs.  9b: benchmarks/benchmark_kdr_GP.py:11-33 at its width
# (N = M = 100, seed 3, Y = X[:, 0], 5 folds, K in {1, 2, 4}, both scales
# 5, a GP fit with 3 restarts per fold).  9c: the five kernels' derivatives
# at phase 3's inputs and the first output's correlation lengths.
KDR_D_FULL, KDR_D_ACTIVE, KDR_OUTPUTS, KDR_N, KDR_SEED = 20, 3, 100, 300, 1
KDR_BENCH_N, KDR_BENCH_SEED, KDR_BENCH_FOLDS, KDR_BENCH_KS = 100, 3, 5, (1, 2, 4)
KERNEL_NAMES = ("SquaredExponential", "Matern52", "UniformSqExp", "UniformMat52", "ProductMat52")


def kdr_demo_problem(pkg):
    """9a's inputs ``(300, 20)``, targets ``(100, 300)`` and the true active
    subspace ``(20, 3)`` (the demo's simulator, its seed; numpy's RNG seeded
    for the design, which the demo leaves unseeded)."""
    import numpy as np

    rng = np.random.RandomState(KDR_SEED)
    w = np.linalg.qr(rng.randn(KDR_D_FULL, KDR_D_ACTIVE))[0]
    np.random.seed(KDR_SEED)
    X = pkg.LatinHypercubeDesign(KDR_D_FULL).sample(KDR_N)
    z = X @ w
    g = np.arange(KDR_OUTPUTS)[:, None]
    Y = (np.sin((1 + 0.02 * g) * z[:, 0]) + (2 + 0.01 * g) * z[:, 1] ** 2
         + (0.5 + 0.003 * g) * np.cos(3 * z[:, 2]) * z[:, 0])
    return X, Y + 0.01 * rng.randn(KDR_OUTPUTS, KDR_N), w


def kdr_bench_losses(pkg, **kw):
    """9b: benchmark_kdr_GP.py's cross-validated L1 losses for each K, by
    ``pkg`` (``kw``, e.g. ``device``, go to its gKDR and GaussianProcess);
    numpy's RNG seeded once, as the benchmark seeds it."""
    import numpy as np

    np.random.seed(KDR_BENCH_SEED)
    X = np.random.rand(KDR_BENCH_N, KDR_BENCH_N)
    Y = X[:, 0].copy()

    def train_model(x, y):
        gp = pkg.fit_GP_MAP(pkg.GaussianProcess(x, y, **kw), n_tries=3)
        return lambda xp: gp.predict(xp)[0]

    return [float(pkg.gKDR._compute_loss(X, Y, train_model, KDR_BENCH_FOLDS, K, X_scale=5.0,
                                         Y_scale=5.0, **kw)) for K in KDR_BENCH_KS]


def deriv_problem(kernel):
    """9c's inputs (phase 3's, ``(210, 14)``) and raw parameters (output 0's
    correlation lengths; the first alone for the uniform forms)."""
    x, _ = make_data(N_OUTPUTS)
    theta = make_thetas()[0][:N_DIM]
    return x, theta[:1] if kernel.form == "uniform" else theta


def nuts_problem():
    """bench.py's NUTS problem (bench.py:245-247): inputs U(0, 1) from
    RandomState(7), targets sin(3 x0) + x1^2 + 0.1 sum(x)."""
    import numpy as np

    rng = np.random.RandomState(7)
    inputs = rng.uniform(0.0, 1.0, size=(N_POINTS, N_DIM))
    return inputs, np.sin(3 * inputs[:, 0]) + inputs[:, 1] ** 2 + 0.1 * inputs.sum(1)


def predict_queries(inputs, samples, n_queries, seed=11):
    """7e's queries: seeded training inputs, each moved by a normal step of
    one posterior correlation length over sqrt(D) in every dimension (the
    lengths from the samples' median raw values), so that the scaled
    squared distance to the input moved is ~1 and K* is far from 0."""
    import numpy as np

    raw = np.median(np.reshape(samples, (-1, np.shape(samples)[-1])), axis=0)[:N_DIM]
    rng = np.random.RandomState(seed)
    step = rng.normal(size=(n_queries, N_DIM)) * np.exp(-raw / 2) / np.sqrt(N_DIM)
    return inputs[rng.randint(len(inputs), size=n_queries)] + step


def oracle_grid():
    """The quadrature grid of tests/test_inference.py:190-193: 301 x 301
    raw (correlation, covariance) points."""
    import numpy as np

    G1, G2 = np.meshgrid(np.linspace(-8.0, 12.0, 301), np.linspace(-10.0, 10.0, 301),
                         indexing="ij")
    return np.stack([G1.ravel(), G2.ravel()], axis=1)


def quadrature_moments(pts, nlp):
    """Posterior mean and variance of the grid ``pts`` weighted by
    ``exp(-nlp)``, and the mass on the grid's edge."""
    import numpy as np

    nlp = np.where(np.isfinite(nlp), nlp, np.inf)
    w = np.exp(-(nlp - nlp.min()))
    w /= w.sum()
    mean = (w[:, None] * pts).sum(0)
    var = (w[:, None] * (pts - mean) ** 2).sum(0)
    ww = w.reshape(301, 301)
    return mean, var, ww[0].sum() + ww[-1].sum() + ww[:, 0].sum() + ww[:, -1].sum()


def oracle_problem(pkg, priors_mod, **kw):
    """The posterior of tests/test_inference.py:164-217: a noiseless 1-D GP
    with a fixed nugget and LogNormal priors, two raw parameters."""
    import numpy as np

    rng = np.random.RandomState(42)
    x = rng.uniform(0, 1, size=(20, 1))
    priors = priors_mod.GPPriors(corr=[priors_mod.LogNormalPrior(0.5, 0.3)],
                                 cov=priors_mod.LogNormalPrior(0.5, 1.0), nugget_type="fixed")
    return pkg.GaussianProcess(x, np.sin(4 * x[:, 0]), nugget=1e-6, priors=priors, **kw)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(shape, dtype, seed):
    import torch

    L, n, m, D = shape
    g = torch.Generator().manual_seed(seed)

    def u(*size):
        return torch.rand(*size, generator=g, dtype=torch.float64)

    return (
        u(L, n, D).to("cuda", dtype),
        u(m, D).to("cuda", dtype),
        torch.exp(2.0 * u(L, D) - 1.0).to("cuda", dtype),
        torch.exp(u(L) - 0.5).to("cuda", dtype),
    )


def phase_kernels(km, main_shape):
    """K1 vs plain version, checked and timed at the bring-up shapes, at the
    headline emulator's former predict tile (the record's shape, timed
    since PR 1) and at ``main_shape``, the tile its path now gives it (the
    large-n predict); returns the kernel's record for the JSON line,
    without ``launches``."""
    import torch

    shapes = [(1, 50, 37, 3), (1, 130, 200, 14), (1, 5, 5, 1), (2, 70, 131, 20),
              (N_OUTPUTS, N_POINTS, 4096, N_DIM), K1_SHAPE, main_shape]
    main_err = main_rel = 0.0
    for dtype in (torch.float32, torch.float64):
        rtol, atol = KERNEL_TOL[str(dtype).replace("torch.", "")]
        for seed, shape in enumerate(shapes):
            for base in ("sqexp", "mat52"):
                args = kernel_inputs(shape, dtype, seed)
                K = km.kernel_matrix(*args, base=base)
                torch.cuda.synchronize()
                P = km.kernel_matrix_plain(*args, base=base)
                err = (K - P).abs()
                max_abs = err.max().item()
                max_rel = (err / P.abs().clamp_min(torch.finfo(dtype).tiny)).max().item()
                ok = bool((err <= atol + rtol * P.abs()).all())
                print("phase 2: kernel_matrix {} {} {} max_abs_err {} max_rel_err {} "
                      "(rtol {}, atol {}) {}".format(
                          str(dtype)[6:], base, shape, max_abs, max_rel, rtol, atol,
                          "ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError("kernel_matrix disagrees with its plain version")
                if shape == K1_SHAPE and dtype == torch.float32 and base == "sqexp":
                    main_err, main_rel = max_abs, max_rel
                del K, P, err, args
        # Matern 5/2 is exactly 1 where r2 == 0
        x1, _, _, _ = kernel_inputs((1, 20, 20, 4), dtype, 99)
        one = torch.ones(1, dtype=dtype, device="cuda")
        K = km.kernel_matrix(x1, x1[0].contiguous(), torch.ones(1, 4, dtype=dtype, device="cuda"),
                             one, base="mat52")
        if not torch.equal(torch.diagonal(K[0]), torch.ones(20, dtype=dtype, device="cuda")):
            raise AssertionError("Matern 5/2 diagonal is not exactly 1")
        print("phase 2: kernel_matrix {} mat52 diagonal exactly 1: ok".format(str(dtype)[6:]))

    timings = {}
    for dtype in (torch.float32, torch.float64):
        for shape in (K1_SHAPE, main_shape):
            args = kernel_inputs(shape, dtype, 7)

            def kern():
                return km.kernel_matrix(*args, base="sqexp")

            def plain():
                return km.kernel_matrix_plain(*args, base="sqexp")

            # plain, kernel, kernel, plain on one card
            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            out_bytes = shape[0] * shape[1] * shape[2] * (4 if dtype == torch.float32 else 8)
            print("phase 2: time sqexp {} {}: kernel {} ms ({} {}), plain {} ms ({} {}); "
                  "kernel writes {} GB/s".format(
                      str(dtype)[6:], shape, ms, k1, k2, plain_ms, p1, p2,
                      out_bytes / (ms * 1e-3) / 1e9))
            timings[(str(dtype)[6:], shape)] = (ms, plain_ms)
            del args
            torch.cuda.empty_cache()
    for shape in (K1_SHAPE, main_shape):
        ms, _ = timings[("float32", shape)]
        bound, bound_by = k1_bound_ms(shape)
        print("phase 2: kernel_matrix float32 {}: {} ms, bound {} ms ({}), {} of the "
              "bound".format(shape, ms, bound, bound_by, bound / ms))
    ms, plain_ms = timings[("float32", K1_SHAPE)]
    bound, bound_by = k1_bound_ms(K1_SHAPE)
    record = {
        "name": "kernel_matrix",
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/kernel_matrix.cu",
        "replaces": "mogp_tpu/ops/pallas_kernels.py:88",
        "shape": list(K1_SHAPE),
        "max_abs_err": main_err,
        "max_rel_err": main_rel,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no one PyTorch call computes this function
        "main_path_shape": list(main_shape),
        "main_path_ms": timings[("float32", main_shape)][0],
    }
    return record


def k1_bound_ms(shape):
    """K1's bound in float32: inputs read once and K written once; per
    element 3 D flops for the scaled squared distance, and the exponential
    and sigma^2 as two."""
    L, n, m, D = shape
    return bound_ms(4 * (L * n * D + m * D + L * D + L + L * n * m), L * n * m * (3 * D + 2))


# phase 2d: the fused prediction at the bring-up shapes (one panel, one
# and a bit, below one, two input chunks), the headline tile, and at the
# route's bounds per type; M = 0 (zero mean) and 15 (a linear mean in 14
# dimensions; D + 1 where D is smaller)
FUSED_SHAPES = [(1, 50, 37, 3), (1, 130, 200, 14), (1, 5, 5, 1), (3, 16, 64, 2),
                (2, 17, 65, 20), K1_SHAPE]
FUSED_M = (0, 15)
# the kernel's error against the float64 plain version may be at most
# FUSED_RATIO times the float32 plain version's (phase 2c's rule), or a few
# ulps of the largest value where both are exact to rounding.  In float64
# the float32 plain error scaled by the ratio of the two epsilons stands in
# for the float32 plain error, twice: there the measured difference holds
# the float64 plain version's own rounding (its matmul-form r2 among it)
# as well as the kernel's
FUSED_RATIO, FUSED_ULPS = 2.0, 8.0


def fused_problem(shape, M, base, seed, dtype):
    """A fitted-GP-shaped problem for the fused kernel, made in float64 on
    the card and cast to ``dtype``: ``(args, args64)``, each the wrapper's
    positional arguments.  Even lanes have long lengthscales (K's condition
    1e6-1e8), every lane the adaptive nugget's first jitter rung (1e-6 of
    sigma^2); the mean is linear in the first ``M - 1`` inputs (``M <= D +
    1``)."""
    import torch
    from mogp_tpu_torch.ops.kernels import _BASE_FNS

    L, n, m, D = shape
    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(*size):
        return torch.rand(*size, generator=g, dtype=f64, device="cuda")

    def design(x):
        cols = [torch.ones_like(x[..., 0])] + [x[..., a] for a in range(M - 1)]
        return torch.stack(cols[:M], dim=-1) if M else x[..., :0]

    x1, x2 = u(L, n, D), u(m, D)
    raw = 2.0 * u(L, D) - 1.0
    raw[::2] -= 3.0
    exp_theta, sigma2 = torch.exp(raw), torch.exp(u(L) - 0.5)
    z = x1 * torch.sqrt(exp_theta)[:, None, :]
    r2 = ((z[:, :, None, :] - z[:, None, :, :]) ** 2).sum(-1)
    nugget = 1e-6 * sigma2
    K = sigma2[:, None, None] * _BASE_FNS[base](r2)
    Lk = torch.linalg.cholesky(K + nugget[:, None, None] * torch.eye(n, dtype=f64, device="cuda"))
    H, dmtest = design(x1), design(x2).contiguous()
    Kinv_dm = torch.cholesky_solve(H, Lk)
    LA = torch.linalg.cholesky(H.transpose(-1, -2) @ Kinv_dm)
    beta = u(L, M)
    alpha = torch.cholesky_solve((u(L, n) - (H @ beta[..., None])[..., 0])[..., None], Lk)[..., 0]
    args64 = [x1, x2, exp_theta, sigma2, Lk, alpha, Kinv_dm, dmtest, beta, LA, sigma2 + nugget]
    args64 = [a.contiguous() for a in args64]
    return [a.to(dtype) for a in args64], args64


def fused_bound_ms(shape, M):
    """The fused kernel's bound in float32: per lane and query n (3 D + 2)
    flops for K*, n^2 for the substitution, 4 n for the mean and |v|^2,
    2 n M + M^2 for r and u; its inputs read once (the factors' lower
    triangles) and mu and var written once."""
    L, n, m, D = shape
    flops = L * m * (n * (3 * D + 2) + n * n + 4 * n + 2 * n * M + M * M)
    elems = (L * n * D + m * D + L * D + L + L * n * (n + 1) // 2 + L * n + L * n * M + m * M
             + L * M + L * M * (M + 1) // 2 + L + 2 * L * m)
    return bound_ms(4 * elems, flops)


def fused_errors(pf, km, mu, var, args64, dtype, base):
    """The kernel's ``mu`` and ``var`` against the float64 plain version on
    the float64 problem ``args64``, with phase 2d's limits: ``(line, ok,
    errors)``, ``errors`` the largest of each.  The ulps floor of ``mu`` counts
    the sums it is made of, ``|dmtest| |beta| + |K*|^T |alpha|`` (alpha is
    large where K is ill-conditioned); that of ``var`` its largest value."""
    import torch

    f32, f64 = torch.float32, torch.float64
    eps_ratio = torch.finfo(f64).eps / torch.finfo(f32).eps
    x1, x2, et, s2, _, alpha, _, dmtest, beta, _, _ = args64
    K = km.kernel_matrix_plain(x1, x2, et, s2, base=base)
    mag_mu = ((K.abs().transpose(-1, -2) @ alpha.abs()[..., None])[..., 0]
              + (dmtest.abs() @ beta.abs()[..., None])[..., 0]).max().item()
    del K
    ref = pf.predict_fused_plain(*args64, base=base)
    p32 = pf.predict_fused_plain(*[a.to(f32) for a in args64], base=base)
    line, ok, errs = [], True, {}
    for name, got, want, plain, mag in (("mu", mu, ref[0], p32[0], mag_mu),
                                        ("var", var, ref[1], p32[1], None)):
        mag = max(1.0, want.abs().max().item()) if mag is None else mag
        err = (got.to(f64) - want).abs().max().item()
        err32 = (plain.to(f64) - want).abs().max().item()
        ref_err = err32 if dtype == f32 else 2.0 * err32 * eps_ratio
        limit = FUSED_RATIO * ref_err + FUSED_ULPS * torch.finfo(dtype).eps * mag
        ok = ok and bool(torch.isfinite(got).all()) and err <= limit
        errs[name] = err
        line.append("{} err {} (f32 plain {}, limit {})".format(name, err, err32, limit))
    return "; ".join(line), ok, errs


def phase_fused(pf, km, main_shape):
    """Phase 2d: the fused prediction against its plain version on the
    card, checked and timed; returns its record for the JSON line, without
    ``launches``."""
    import torch

    f32, f64 = torch.float32, torch.float64
    cases = [(dt, shape, min(M, shape[3] + 1), base) for dt in (f32, f64)
             for shape in FUSED_SHAPES for M in FUSED_M for base in ("sqexp", "mat52")]
    cases += [(dt, (2, pf.N_FUSED[dt], 300, pf.M_FUSED - 1), pf.M_FUSED, "sqexp")
              for dt in (f32, f64)]
    for seed, (dtype, shape, M, base) in enumerate(cases):
        args, args64 = fused_problem(shape, M, base, seed, dtype)
        before = pf.launches
        mu, var = pf.predict_fused(*args, base=base)
        mu_nounc, var_nounc = pf.predict_fused(*args, unc=False, base=base)
        torch.cuda.synchronize()
        if pf.launches != before + 2:
            raise AssertionError("predict_fused did not launch its kernel")
        line, ok, _ = fused_errors(pf, km, mu, var, args64, dtype, base)
        ok = ok and var_nounc is None and torch.equal(mu, mu_nounc)
        print("phase 2d: predict_fused {} {} M={} {}: {}; unc off: same mu, no var {}".format(
            str(dtype)[6:], base, M, shape, line, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("predict_fused disagrees with its plain version")
        del args, args64, mu, var
    torch.cuda.empty_cache()

    # the main path's own shape: the kernel over every query, the plain
    # version on every 97th (columns are independent)
    args, args64 = fused_problem(main_shape, 0, "sqexp", 1234, f32)
    mu, var = pf.predict_fused(*args)
    idx = torch.cat([torch.arange(0, main_shape[2], 97, device="cuda"),
                     torch.arange(main_shape[2] - 3, main_shape[2], device="cuda")])
    sub = list(args64)
    sub[1], sub[7] = args64[1][idx].contiguous(), args64[7][idx].contiguous()
    line, ok, main_errs = fused_errors(pf, km, mu[:, idx], var[:, idx], sub, f32, "sqexp")
    print("phase 2d: predict_fused float32 sqexp M=0 {} (the main path's tile), {} of its "
          "columns: {} {}".format(main_shape, idx.numel(), line, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("predict_fused disagrees with its plain version at the main shape")
    main_ms = time_ms(lambda: pf.predict_fused(*args), reps=5, warmup=1)
    bound, bound_by = fused_bound_ms(main_shape, 0)
    print("phase 2d: time predict_fused float32 {}: {} ms, bound {} ms ({}), {} of the "
          "bound".format(main_shape, main_ms, bound, bound_by, bound / main_ms))
    del args, args64, mu, var, sub
    torch.cuda.empty_cache()

    def unfused(x1, x2, et, s2, Lk, alpha, Kinv_dm, dmtest, beta, LA, var_shift):
        """Today's chain on the card before the fused kernel: K1, then the
        products, cuBLAS's triangular solve and the reductions."""
        K = km.kernel_matrix(x1, x2, et, s2)
        mu = (dmtest @ beta[..., None])[..., 0] + (K.transpose(-1, -2) @ alpha[..., None])[..., 0]
        R = dmtest.T - Kinv_dm.transpose(-1, -2) @ K
        v = torch.linalg.solve_triangular(Lk, K, upper=False)
        u = torch.linalg.solve_triangular(LA, R, upper=False) if LA.shape[-1] else R
        return mu, torch.clamp_min(var_shift[:, None] - (v**2).sum(-2) + (u**2).sum(-2), 0.0)

    timings = {}
    for dtype in (f32, f64):
        for M in (min(M, K1_SHAPE[3] + 1) for M in FUSED_M):
            args, _ = fused_problem(K1_SHAPE, M, "sqexp", 7, dtype)

            def kern():
                return pf.predict_fused(*args)

            def plain():
                return pf.predict_fused_plain(*args)

            def chain():
                return unfused(*args)

            # plain, unfused, kernel, kernel, unfused, plain on one card
            p1, u1, k1, k2, u2, p2 = (time_ms(plain), time_ms(chain), time_ms(kern),
                                      time_ms(kern), time_ms(chain), time_ms(plain))
            ms, plain_ms, chain_ms = (k1 + k2) / 2, (p1 + p2) / 2, (u1 + u2) / 2
            bound, bound_by = fused_bound_ms(K1_SHAPE, M)
            print("phase 2d: time predict_fused {} M={} {}: kernel {} ms ({} {}), unfused chain "
                  "{} ms ({} {}), plain {} ms ({} {}); bound (float32 peaks) {} ms ({}), {} of "
                  "it".format(str(dtype)[6:], M, K1_SHAPE, ms, k1, k2, chain_ms, u1, u2,
                              plain_ms, p1, p2, bound, bound_by, bound / ms))
            timings[(dtype, M)] = (ms, plain_ms, chain_ms, bound, bound_by)
            del args
            torch.cuda.empty_cache()
    ms, plain_ms, chain_ms, bound, bound_by = timings[(f32, 0)]
    return {
        "name": "predict_fused",
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/kernel_matrix.cu",
        "replaces": "mogp_tpu/ops/pallas_kernels.py:88",
        "shape": list(K1_SHAPE),
        # at the main path's tile, on the sampled columns
        "max_abs_err": max(main_errs.values()),
        "max_abs_err_mu": main_errs["mu"],
        "max_abs_err_var": main_errs["var"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        # no one PyTorch call computes this function; in its place the
        # unfused chain (K1, the products, the triangular solve, the sums)
        "library_ms": None,
        "unfused_ms": chain_ms,
        "main_path_shape": list(main_shape),
        "main_path_ms": main_ms,
    }


def _rel_err(L, P):
    return ((L - P).abs().max() / P.abs().max()).item()


def spd_batch(B, n, dtype, seed):
    """``X X^T + n I`` with X standard normal from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, n, generator=g, dtype=torch.float64, device="cuda")
    A = X @ X.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64, device="cuda")
    return A.to(dtype)


def _launch_once(kb, A):
    """``cholesky_batched(A)``, checking that it launched K2 once."""
    import torch

    if kb.route(A.shape[-1], A.dtype) != "k2":
        raise AssertionError("phase 2b shape above K2's bound")
    before = kb.launches
    L = kb.cholesky_batched(A)
    torch.cuda.synchronize()
    if kb.launches != before + 1:
        raise AssertionError("cholesky_batched did not launch its kernel once")
    return L


def _check_bad_lane(kb, A, label):
    """Lane 1 of ``A`` is ``-I``: it must come out all NaN, the others
    finite and within the limit of their plain factors."""
    import torch

    tol = CHOL_TOL[str(A.dtype)[6:]]
    L = _launch_once(kb, A)
    P = kb.cholesky_batched_plain(A)
    good = [i for i in range(A.shape[0]) if i != 1]
    err = _rel_err(L[good], P[good])
    ok = (bool(torch.isnan(L[1]).all()) and bool(torch.isnan(P[1]).all())
          and bool(torch.isfinite(L[good]).all()) and err <= tol)
    print("phase 2b: cholesky_batched {} {} with lane 1 = -I: lane 1 all NaN {}, "
          "others finite {}, rel err {} (limit {}) {}".format(
              str(A.dtype)[6:], label, bool(torch.isnan(L[1]).all()),
              bool(torch.isfinite(L[good]).all()), err, tol, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("cholesky_batched fails the non-PD lane check")


def phase_cholesky(kb):
    """K2 against its plain version, checked and timed, up to its bound
    ``max_shared_n`` (larger n are phase 2c's); returns the kernel's record
    for the JSON line, without ``launches``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(5)  # the input of tests/test_pallas.py:34-55
    A = rng.randn(4, 40, 40)
    A = A @ np.transpose(A, (0, 2, 1)) + 40 * np.eye(40)
    A[1] = -np.eye(40)
    main = (960, N_POINTS)
    main_err = main_rel = 0.0
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        tol = CHOL_TOL[name]
        bound = kb.max_shared_n(dtype)
        _check_bad_lane(kb, torch.as_tensor(A, dtype=dtype, device="cuda"), "(4, 40, 40)")
        shapes = [main, (384, N_POINTS), (N_OUTPUTS, 15), (16, 1), (8, bound)]
        for seed, (B, n) in enumerate(shapes):
            A_ = spd_batch(B, n, dtype, seed)
            L = _launch_once(kb, A_)
            P = kb.cholesky_batched_plain(A_)
            err = _rel_err(L, P)
            upper0 = bool((torch.triu(L, 1) == 0).all())
            ok = err <= tol and upper0 and bool(torch.isfinite(L).all())
            print("phase 2b: cholesky_batched {} ({}, {}, {}): rel err {} (limit {}), "
                  "max abs err {}, upper triangle zero {} {}".format(
                      name, B, n, n, err, tol, (L - P).abs().max().item(), upper0,
                      "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("cholesky_batched disagrees with its plain version")
            if (B, n) == main and dtype == torch.float32:
                main_err, main_rel = (L - P).abs().max().item(), err
            del A_, L, P

    timings = {}
    for dtype in (torch.float32, torch.float64):
        for B, n in (main, (384, N_POINTS)):
            A_ = spd_batch(B, n, dtype, 7)

            def kern():
                return kb.cholesky_batched(A_)

            def plain():
                return kb.cholesky_batched_plain(A_)

            def library():
                return torch.linalg.cholesky_ex(A_)

            # in turns on one card: plain, library, kernel, kernel, library, plain
            p1, l1, k1, k2, l2, p2 = (time_ms(f) for f in (plain, library, kern, kern, library,
                                                            plain))
            ms, plain_ms, lib_ms = (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2
            flops = B * n**3 / 3
            bound, bound_by = chol_bound_ms(B, n, dtype)
            print("phase 2b: time cholesky_batched {} ({}, {}, {}): kernel {} ms ({} {}), "
                  "plain {} ms ({} {}), cholesky_ex {} ms ({} {}); kernel / cholesky_ex {}; "
                  "bound {} ms ({}), kernel at {} of it; kernel {} GFLOP/s, {} us per "
                  "matrix".format(
                      str(dtype)[6:], B, n, n, ms, k1, k2, plain_ms, p1, p2, lib_ms, l1, l2,
                      ms / lib_ms, bound, bound_by, bound / ms, flops / (ms * 1e-3) / 1e9,
                      ms * 1e3 / B))
            timings[(str(dtype)[6:], B, n)] = (ms, plain_ms, lib_ms, bound, bound_by)
            del A_
            torch.cuda.empty_cache()
    ms, plain_ms, lib_ms, bound, bound_by = timings[("float32",) + main]
    return {
        "name": "cholesky_batched",
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/cholesky_batched.cu",
        "replaces": "tools/pallas_cholesky_experiment.py:124",
        "max_abs_err": main_err,
        "max_rel_err": main_rel,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": lib_ms,  # torch.linalg.cholesky_ex, the same function without the NaN mask
    }


# phase 2c: K3-K5 (tools/exp_chol.py) against cholesky_blocked_plain
BLOCKED_REPLACES = {"v1": "tools/exp_chol.py:111", "v2": "tools/exp_chol.py:269",
                    "v3": "tools/exp_chol.py:411"}
BLOCKED_SHAPES = [((64, 341), "float32"), ((4, 241), "float64"), ((15, 1000), "float32"),
                  ((15, 1000), "float64"), ((1, 4096), "float32"), ((1, 8192), "float32"),
                  ((384, 341), "float32"), ((4, 4096), "float32"), ((1, 4096), "float64"),
                  ((25, 4096), "float32")]
BLOCKED_MAIN = ((1, 4096), "float32")  # the factorization of the large-n slice, phase 5
BLOCKED_MICE = ((25, 4096), "float32")  # the candidate blocks of a MICE step, phase 8
# the ill-conditioned K: a variant's error against the float64 factor may
# be at most this multiple of cholesky_ex's own
ILL_RATIO = 2.0

# phase 5: the large-n GP (benchmarks/benchmark_large_n.py, bench.py:300-365)
LARGE_N, LARGER_N, MAP_TRIES, MAP_MAXITER, LARGE_N_QUERIES = 4096, 8192, 4, 20, 10**5
# float32 on the card against float64 on the CPU at the card's realized
# nugget, and float64 on the card against float64 on the CPU
LARGE_N_TOL = {"float32": 1e-3, "float64": 1e-9}


def _blocked_once(kbl, A, variant):
    """``cholesky_blocked_ex(A, variant)``, checking that it ran one panel
    loop; returns ``(L, info)``."""
    import torch

    before = dict(kbl.launches)
    L, info = kbl.cholesky_blocked_ex(A, variant)
    torch.cuda.synchronize()
    after = dict(kbl.launches)
    before[variant] += 1
    if after != before:
        raise AssertionError("cholesky_blocked did not count one launch of {}".format(variant))
    return L, info


def _check_blocked(kbl, A, variant, label, bad=None):
    """Variant against the plain version on ``A``: the lanes of ``bad``
    (lane -> the 1-based column of its failing pivot) all NaN with that
    ``info``, the others finite with ``info`` 0, upper triangle exactly
    zero, within ``CHOL_TOL``.  Returns (rel err, max abs err)."""
    import torch

    bad = bad or {}
    dtype = str(A.dtype)[6:]
    tol = CHOL_TOL[dtype]
    L, info = _blocked_once(kbl, A, variant)
    P = kbl.cholesky_blocked_plain(A)
    good = [i for i in range(A.shape[0]) if i not in bad]
    err = _rel_err(L[good], P[good])
    abs_err = (L[good] - P[good]).abs().max().item()
    nan_ok = all(bool(torch.isnan(L[i]).all()) for i in bad)
    want = [bad.get(i, 0) for i in range(A.shape[0])]
    info_ok = info.tolist() == want
    upper0 = bool((torch.triu(L[good], 1) == 0).all())
    ok = (nan_ok and info_ok and upper0 and bool(torch.isfinite(L[good]).all())
          and bool(torch.isfinite(P[good]).all()) and err <= tol)
    print("phase 2c: cholesky_blocked {} {} {}: rel err {} (limit {}), max abs err {}, upper "
          "triangle zero {}{}, info as expected {} {}".format(
              variant, dtype, label, err, tol, abs_err, upper0,
              ", lanes {} all NaN {} (info {})".format(
                  sorted(bad), nan_ok, [info[i].item() for i in sorted(bad)]) if bad else "",
              info_ok, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("cholesky_blocked {} disagrees with its plain version".format(variant))
    return err, abs_err


def _check_blocked_ill(kbl, K, variant, label):
    """Variant against the float64 factor of the same float32 matrix ``K``,
    whose condition (~1e7) leaves no two float32 factorizations within
    ``CHOL_TOL`` of each other: its error must be within ``ILL_RATIO`` of
    ``cholesky_ex``'s own, and its backward error max |L L^T - K| / max |K|
    within ``CHOL_TOL``."""
    import torch

    L, _ = _blocked_once(kbl, K, variant)
    P = kbl.cholesky_blocked_plain(K)
    truth = kbl.cholesky_blocked_plain(K.double())
    err, err_plain = _rel_err(L.double(), truth), _rel_err(P.double(), truth)
    Ld = L.double()
    back = ((Ld @ Ld.transpose(-1, -2) - K.double()).abs().max() / K.abs().max()).item()
    tol = CHOL_TOL["float32"]
    ok = (bool(torch.isfinite(L).all()) and bool(torch.isfinite(truth).all())
          and err <= max(ILL_RATIO * err_plain, tol) and back <= tol)
    print("phase 2c: cholesky_blocked {} float32 {}: rel err against the float64 factor {} "
          "(cholesky_ex's {}, limit {}x that), vs cholesky_ex {}, backward error {} (limit {}) "
          "{}".format(variant, label, err, err_plain, ILL_RATIO, _rel_err(L, P), back, tol,
                      "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("cholesky_blocked {} loses accuracy on an ill-conditioned "
                             "K".format(variant))


def large_n_K(n):
    """The SquaredExponential K (sigma^2 included) of the n-point large-n
    problem at its raw theta, on the card in float32, with the jitter that
    the port's fit on the card realizes for it; returns ``(K + jitter I,
    jitter)``."""
    import mogp_tpu_torch
    from mogp_tpu_torch.tools.large_n import jittered_K, make_problem

    x, y, theta = make_problem(n)
    gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cuda")
    gp.fit(theta)
    return jittered_K(gp, theta), gp.nugget


def phase_blocked(kbl):
    """K3-K5 against their plain version, checked and timed against
    ``cholesky_ex``; returns one record per variant for the JSON line,
    without ``launches``."""
    import torch

    errs = {}
    for seed, ((B, n), dtype_name) in enumerate(BLOCKED_SHAPES):
        dtype = getattr(torch, dtype_name)
        A = spd_batch(B, n, dtype, 50 + seed)
        bad = {}
        if B >= 4:  # where the batch has room: a non-PD lane, and a lane
            # whose pivot fails two thirds of the way down
            A[1] = -torch.eye(n, dtype=dtype, device="cuda")
            c = n - n // 3
            A[3, c, c] = -A[3, c, c]
            bad = {1: 1, 3: c + 1}
        for variant in kbl.VARIANTS:
            errs[(variant, (B, n), dtype_name)] = _check_blocked(
                kbl, A, variant, "({}, {}, {})".format(B, n, n), bad)
        del A
        torch.cuda.empty_cache()
    K, jitter = large_n_K(LARGE_N)
    for variant in kbl.VARIANTS:
        _check_blocked_ill(kbl, K, variant, "(1, {0}, {0}) SqExp K of the large-n problem + its "
                           "realized jitter {1}".format(LARGE_N, jitter))
    del K

    timings = {}
    for (B, n), dtype_name in BLOCKED_SHAPES:
        dtype = getattr(torch, dtype_name)
        A = spd_batch(B, n, dtype, 7)
        reps, warmup = (3, 1) if n >= LARGER_N else (10, 2) if n >= LARGE_N else (20, 3)

        def timer(variant):
            if variant == "plain":
                return time_ms(lambda: kbl.cholesky_blocked_plain(A), reps, warmup)
            if variant == "library":
                return time_ms(lambda: torch.linalg.cholesky_ex(A), reps, warmup)
            return time_ms(lambda: kbl.cholesky_blocked(A, variant), reps, warmup)

        order = ["plain", "library", *kbl.VARIANTS, *reversed(kbl.VARIANTS), "library", "plain"]
        got = {}
        for v in order:
            got.setdefault(v, []).append(timer(v))
        ms = {v: sum(t) / len(t) for v, t in got.items()}
        flops = B * n**3 / 3
        bound, bound_by = chol_bound_ms(B, n, dtype)
        print("phase 2c: time ({}, {}, {}) {}: plain {} ms {}, cholesky_ex {} ms {}; bound {} ms "
              "({}); {}".format(
                  B, n, n, dtype_name, ms["plain"], got["plain"], ms["library"], got["library"],
                  bound, bound_by, "; ".join(
                      "{} {} ms {} = {} GFLOP/s, / cholesky_ex {}, {} of the bound".format(
                          v, ms[v], got[v], flops / (ms[v] * 1e-3) / 1e9, ms[v] / ms["library"],
                          bound / ms[v])
                      for v in kbl.VARIANTS)))
        timings[((B, n), dtype_name)] = dict(ms, bound=bound, bound_by=bound_by)
        del A
        torch.cuda.empty_cache()
    main, mice = timings[BLOCKED_MAIN], timings[BLOCKED_MICE]
    fastest = min(kbl.VARIANTS, key=lambda v: main[v])
    print("phase 2c: fastest variant at {} {}: {}".format(*BLOCKED_MAIN, fastest))
    return [{
        "name": "cholesky_blocked_" + v,
        "route": "cuda",
        "source": "mogp_tpu_torch/csrc/cholesky_blocked.cu",
        "replaces": BLOCKED_REPLACES[v],
        "max_abs_err": errs[(v,) + BLOCKED_MAIN][1],
        "max_rel_err": errs[(v,) + BLOCKED_MAIN][0],
        "ms": main[v],
        "plain_ms": main["plain"],
        "bound_ms": main["bound"],
        "bound_by": main["bound_by"],
        "library_ms": main["library"],  # torch.linalg.cholesky_ex
        "at_mice_batch": {"shape": list(BLOCKED_MICE[0]) + [BLOCKED_MICE[0][1]],
                          "max_abs_err": errs[(v,) + BLOCKED_MICE][1],
                          "ms": mice[v], "plain_ms": mice["plain"], "bound_ms": mice["bound"],
                          "bound_by": mice["bound_by"], "library_ms": mice["library"]},
    } for v in kbl.VARIANTS]


class forbid_cholesky_ex_on_cuda:
    """Within the block, ``torch.linalg.cholesky_ex`` / ``cholesky`` raise on
    a CUDA tensor: the path must factor with the port's kernels."""

    def __enter__(self):
        import torch

        self.saved = torch.linalg.cholesky_ex, torch.linalg.cholesky

        def guard(fn):
            def wrapped(A, *args, **kwargs):
                if A.is_cuda:
                    raise AssertionError("a CUDA tensor reached torch.linalg." + fn.__name__)
                return fn(A, *args, **kwargs)
            return wrapped

        torch.linalg.cholesky_ex, torch.linalg.cholesky = (guard(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        import torch

        torch.linalg.cholesky_ex, torch.linalg.cholesky = self.saved
        return False


def _route_launches(kbl, variant, fn):
    """Run ``fn()`` and return the launches of ``variant`` it made."""
    before = kbl.launches[variant]
    fn()
    return kbl.launches[variant] - before


def phase_large_n(mogp_tpu_torch, km, kb, kbl, pf, label):
    """The large-n GP slice (module doc, phase 5); returns the routed
    blocked variant, the launches of each blocked variant in it and K1's
    launches in it."""
    import numpy as np
    import torch
    from mogp_tpu_torch.tools import large_n

    route = kb.route(LARGE_N, torch.float32)
    if route != kb.route(LARGER_N, torch.float32) or route not in kbl.VARIANTS:
        raise AssertionError("the large-n sizes are not routed to one blocked variant")
    if pf.route("cuda", LARGE_N, 0, "stationary", False, torch.float32) != "unfused":
        raise AssertionError("the large-n predict is not on K1's route")
    torch.cuda.synchronize()
    km.launches = kb.launches = pf.launches = 0
    for v in kbl.VARIANTS:
        kbl.launches[v] = 0
    with forbid_cholesky_ex_on_cuda():
        x, y, theta = large_n.make_problem(LARGE_N)
        rows = {}
        for n, oracle in ((LARGE_N, True), (LARGER_N, False)):
            row, g = large_n.measure(n, iters=3, oracle=oracle)
            rows[n] = row
            per_fit = _route_launches(kbl, route, lambda g=g: g.fit(theta))
            print("phase 5: " + large_n.format_row(row) + "; {} launches of {} per fit ({} "
                  "rungs) on {}".format(per_fit, route, row["rungs"], label))
            if (per_fit != row["rungs"] or not np.isfinite(row["nlp"])
                    or not row["valgrad_finite"]):
                raise AssertionError("the large-n fit at n={} did not run one {} launch per "
                                     "rung, or is not finite".format(n, route))
            del g
            torch.cuda.empty_cache()

        # the MAP fit, seeded with numpy, 4 restarts as lanes
        gp = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cuda")
        np.random.seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mogp_tpu_torch.fit_GP_MAP(gp, n_tries=MAP_TRIES, maxiter=MAP_MAXITER)
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        print("phase 5: fit_GP_MAP n={}, {} restarts, maxiter={}: {} s, winner NLP {}, nugget {}, "
              "theta {}".format(LARGE_N, MAP_TRIES, MAP_MAXITER, map_s, gp.current_logpost,
                                gp.nugget, gp.theta.get_data().tolist()))
        if not np.isfinite(gp.current_logpost):
            raise AssertionError("the large-n MAP fit did not converge to a finite NLP")

        q = np.random.RandomState(2).uniform(size=(LARGE_N_QUERIES, large_n.N_DIM))
        k1_before = km.launches
        t0 = time.perf_counter()
        res = gp.predict(q)  # host arrays: the device work is done
        predict_s = time.perf_counter() - t0
        print("phase 5: predict {} points at n={}: {} s = {} points/s; K1 launches {}".format(
            LARGE_N_QUERIES, LARGE_N, predict_s, LARGE_N_QUERIES / predict_s,
            km.launches - k1_before))
        if not (res.mean.shape == (LARGE_N_QUERIES,) and np.isfinite(res.mean).all()
                and np.isfinite(res.unc).all() and (res.unc >= 0).all()):
            raise AssertionError("the large-n prediction is not finite, or has a negative "
                                 "variance")
        if km.launches == k1_before:
            raise AssertionError("the large-n prediction did not launch K1")

        # float32 on the card against float64 on the CPU at the card's
        # nugget (the tool's oracle); float64 on the card against float64
        # on the CPU, both adaptive
        row = rows[LARGE_N]
        t0 = time.perf_counter()
        g64 = mogp_tpu_torch.GaussianProcess(x, y, nugget="adaptive", device="cuda",
                                             dtype=torch.float64)
        g64.fit(theta)
        lp64, nugget64 = large_n.cpu_logpost(x, y, theta)
        rel64 = abs(g64.current_logpost - lp64) / abs(lp64)
        ok = (row["nlp_rel_err"] <= LARGE_N_TOL["float32"] and rel64 <= LARGE_N_TOL["float64"]
              and math.isclose(g64.nugget, nugget64, rel_tol=LARGE_N_TOL["float64"]))
        print("phase 5: n={} logpost: float32 card {} vs float64 CPU at nugget {} fixed {}: rel "
              "{} (limit {}); float64 card {} (nugget {}) vs float64 CPU {} (nugget {}): rel {} "
              "(limit {}); float64 fits took {} s {}".format(
                  LARGE_N, row["nlp"], row["nugget"], row["nlp_cpu64"], row["nlp_rel_err"],
                  LARGE_N_TOL["float32"], g64.current_logpost, g64.nugget, lp64, nugget64, rel64,
                  LARGE_N_TOL["float64"], time.perf_counter() - t0, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("the large-n log posterior disagrees with the float64 CPU")
    torch.cuda.synchronize()
    launches = dict(kbl.launches)
    print("phase 5: launches K1 {}, predict_fused {}, K2 {}, blocked {} (the route: {})".format(
        km.launches, pf.launches, kb.launches, launches, route))
    if launches[route] == 0 or km.launches == 0:
        raise AssertionError("the routed blocked variant or K1 did not launch in phase 5")
    return route, launches, km.launches


def phase_slice(mogp_tpu_torch, km, kb, pf, label):
    """The serving path (module doc, phase 3); returns the fused kernel's
    launches in it."""
    import numpy as np
    import torch

    x, y = make_data(N_OUTPUTS)
    thetas = make_thetas()
    q = np.random.RandomState(1).uniform(size=(N_QUERIES, N_DIM))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.launches = kb.launches = pf.launches = 0
    t0 = time.perf_counter()
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    t1 = time.perf_counter()
    mgp.fit(thetas)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = mgp.predict(q)  # returns host arrays: the device work is done
    t3 = time.perf_counter()
    launches, k1_launches, chol_launches = pf.launches, km.launches, kb.launches

    if res.mean.shape != (N_OUTPUTS, N_QUERIES) or res.unc.shape != (N_OUTPUTS, N_QUERIES):
        raise AssertionError("prediction has the wrong shape")
    if not np.isfinite(res.mean).all():
        raise AssertionError("non-finite predictive means")
    if not (np.isfinite(res.unc).all() and (res.unc >= 0).all()):
        raise AssertionError("predictive variances not finite and >= 0")
    # the fused route builds no (L, n, tile) K*: only K1 would allocate one
    if launches <= 0 or chol_launches <= 0 or k1_launches != 0:
        raise AssertionError("the serving path did not launch predict_fused and "
                             "cholesky_batched, or launched kernel_matrix")
    peak = torch.cuda.max_memory_allocated()
    construct_s, fit_s, predict_s = t1 - t0, t2 - t1, t3 - t2
    print("phase 3: MultiOutputGP {} outputs, n={}, D={}, float32 on {}: construct {} s, "
          "fit {} s, predict {} points {} s = {} points/s ({} output-points/s); "
          "predict_fused launches {}, kernel_matrix launches {}, cholesky_batched launches {}; "
          "peak device memory {} GB (one (L, n, 4864) float32 K* was {} GB)".format(
              N_OUTPUTS, N_POINTS, N_DIM, label, construct_s, fit_s, N_QUERIES, predict_s,
              N_QUERIES / predict_s, N_OUTPUTS * N_QUERIES / predict_s, launches, k1_launches,
              chol_launches, peak / 1e9, 4 * N_OUTPUTS * N_POINTS * 4864 / 1e9))

    # the same fit and predict again, warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgp.fit(thetas)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res2 = mgp.predict(q)
    t2 = time.perf_counter()
    print("phase 3: warm repeat on {}: fit {} s, predict {} s = {} points/s; "
          "identical results: {}".format(
              label, t1 - t0, t2 - t1, N_QUERIES / (t2 - t1),
              bool(np.array_equal(res.mean, res2.mean) and np.array_equal(res.unc, res2.unc))))
    del res2

    # reference: the port on the CPU in float64, first 4096 queries
    t0 = time.perf_counter()
    ref = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    ref.fit(thetas)
    rr = ref.predict(q[:N_CHECK])
    ref_s = time.perf_counter() - t0
    d_mean = float(np.max(np.abs(res.mean[:, :N_CHECK] - rr.mean)))
    d_unc = float(np.max(np.abs(res.unc[:, :N_CHECK] - rr.unc)))
    lp_gpu = np.array([em.current_logpost for em in mgp.emulators])
    lp_cpu = np.array([em.current_logpost for em in ref.emulators])
    d_lp = float(np.max(np.abs(lp_gpu - lp_cpu) / np.abs(lp_cpu)))
    nug_gpu = np.array([em.nugget for em in mgp.emulators])
    nug_cpu = np.array([em.nugget for em in ref.emulators])
    ok = (d_mean <= SLICE_TOL["mean"] and d_unc <= SLICE_TOL["unc"]
          and d_lp <= SLICE_TOL["logpost_rel"])
    print("phase 3: float32 {} vs float64 CPU on {} queries: max |d mean| {} (limit {}), "
          "max |d var| {} (limit {}), max rel d logpost {} (limit {}); jittered outputs "
          "{} vs {}; CPU reference took {} s: {}".format(
              label, N_CHECK, d_mean, SLICE_TOL["mean"], d_unc, SLICE_TOL["unc"], d_lp,
              SLICE_TOL["logpost_rel"], int((nug_gpu > 0).sum()), int((nug_cpu > 0).sum()),
              ref_s, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's predictions disagree with the float64 reference")
    return launches


def phase_fit(mogp_tpu_torch, km, kb, label, keep):
    """The MAP fit at full width (bench.py:107-128); returns K2's launches.
    Keeps its winners and the float64 CPU fit's NLPs for phase 10."""
    import numpy as np
    import torch
    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.utils.metrics import fits_per_sec

    x, y = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    np.random.seed(0)
    t0 = time.perf_counter()
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=MAXITER)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    km.launches = kb.launches = 0
    np.random.seed(1)
    t0 = time.perf_counter()
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=MAXITER)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, km_launches = kb.launches, km.launches
    peak = torch.cuda.max_memory_allocated()
    n_fit = len(mgp.get_indices_fit())
    phases = {}
    for k, v in fitting.last_phase_times:
        phases[k] = phases.get(k, 0.0) + v
    print("phase 4: fit_GP_MAP {} outputs x {} restarts, n={}, D={}, maxiter={}, float32 on {}: "
          "warm-up fit {} s; timed fit {} s = mogp_tsunami_fits_per_sec {}; phases {}; "
          "outputs fit {}; cholesky_batched launches {} (kernel_matrix {}); peak device "
          "memory {} GB".format(
              N_OUTPUTS, N_TRIES, N_POINTS, N_DIM, MAXITER, label, warm_s, fit_s,
              fits_per_sec(n_fit, fit_s), phases, n_fit, launches, km_launches, peak / 1e9))
    if n_fit != N_OUTPUTS:
        raise AssertionError("only {} of {} outputs were fit".format(n_fit, N_OUTPUTS))
    if launches <= 0:
        raise AssertionError("the MAP fit did not launch cholesky_batched")

    # quality: the same seeded fit of the first outputs in float64 on the
    # CPU; the card's winners re-evaluated in float64 by gp_fit
    t0 = time.perf_counter()
    ref = mogp_tpu_torch.MultiOutputGP(x, y[:N_QUALITY], nugget="adaptive", device="cpu")
    np.random.seed(1)
    mogp_tpu_torch.fit_GP_MAP(ref, n_tries=N_TRIES, refit=True, maxiter=MAXITER)
    cpu_s = time.perf_counter() - t0
    card = mogp_tpu_torch.MultiOutputGP(x, y[:N_QUALITY], nugget="adaptive", device="cpu")
    card.fit([em.theta.get_data() for em in mgp.emulators[:N_QUALITY]])
    nlp_card = np.array([em.current_logpost for em in card.emulators])
    nlp_cpu = np.array([em.current_logpost for em in ref.emulators])
    gap = float(np.mean(nlp_card - nlp_cpu))
    ok = bool(np.isfinite(nlp_card).all()) and gap <= NLP_GAP
    print("phase 4: quality on the first {} outputs: card winners in float64 NLP {}, float64 "
          "CPU fit NLP {} (took {} s); float32 NLP on the card {}; mean gap {} (limit {}) "
          "{}".format(N_QUALITY, nlp_card.tolist(), nlp_cpu.tolist(), cpu_s,
                      [em.current_logpost for em in mgp.emulators[:N_QUALITY]], gap, NLP_GAP,
                      "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's MAP fit is worse than the float64 reference")
    keep["fit_thetas"] = [em.theta.get_data() for em in mgp.emulators]
    keep["fit_nlp_cpu"] = nlp_cpu
    return launches, mgp


def _unpermuted(errors):
    """Standard errors ``[(e, P), ...]`` as z-scores in the points' order."""
    import numpy as np

    z = np.empty((len(errors), len(errors[0][0])))
    for i, (e, P) in enumerate(errors):
        z[i, P] = e
    return z


def phase_uq(mogp_tpu_torch, km, kb, pf, label, keep):
    """The UQ workflow at full width (module doc, phase 6): the design, the
    10^7-point history-matching sweep, validation and a pivot-nugget
    emulator; returns the sweep's launches of the fused kernel.  Keeps the
    sweep's emulator, observations, coords and I for phase 10."""
    import numpy as np
    import torch
    from mogp_tpu_torch.uq import history_matching as thm
    from mogp_tpu_torch.uq import validation
    from mogp_tpu_torch.uq.experimental_design import MaxiMinLHC

    t_phase = time.perf_counter()
    # design: the chosen candidate, re-scored in float64, must be the best
    np.random.seed(0)
    t0 = time.perf_counter()
    design = mogp_tpu_torch.MaxiMinLHC(N_DIM, device="cuda").sample(N_POINTS,
                                                                  n_tries=N_DESIGN_TRIES)
    design_s = time.perf_counter() - t0
    np.random.seed(0)  # the candidates MaxiMinLHC drew (mogp_tpu's draws)
    shape = (N_DESIGN_TRIES, N_POINTS, N_DIM)
    cands = (np.argsort(np.random.random(shape), axis=1) + np.random.random(shape)) / N_POINTS
    MaxiMinLHC._score_candidates(cands, "cuda")
    t0 = time.perf_counter()
    MaxiMinLHC._score_candidates(cands, "cuda")
    score_s = time.perf_counter() - t0
    scores64 = MaxiMinLHC._score_candidates(cands, "cpu")
    chosen = np.flatnonzero((cands == design).all(axis=(1, 2)))
    gap = float((scores64.max() - scores64[chosen].max()) / scores64.max()) if chosen.size else 1.0
    print("phase 6: MaxiMinLHC {} samples x {} parameters from {} candidates on {}: sample {} s, "
          "scoring on the card {} s (warm); chosen candidate {} scores {} in float64, the best "
          "{}: rel gap {} (limit {})".format(
              N_POINTS, N_DIM, N_DESIGN_TRIES, label, design_s, score_s, chosen.tolist(),
              scores64[chosen].tolist(), scores64.max(), gap, DESIGN_RTOL))
    if gap > DESIGN_RTOL:
        raise AssertionError("the card's MaxiMin choice is not the float64 best")

    # the sweep: 10^7 coords through the fused kernel, top-k on the card
    x, y = make_data(N_OUTPUTS)
    thetas = make_thetas()
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    mgp.fit(thetas)
    obs, xv, yv = uq_problem()
    t0 = time.perf_counter()
    coords = uq_coords(mogp_tpu_torch.MonteCarloDesign, N_SWEEP)
    coords_s = time.perf_counter() - t0
    if N_SWEEP < thm._DEVICE_SWEEP_MIN_COORDS:
        raise AssertionError("the sweep is below the device sweep's threshold")
    hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords)
    hm.get_implausibility(0.0, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.launches = kb.launches = pf.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    I = hm.get_implausibility(0.0, 1)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    fused, k1 = pf.launches, km.launches
    peak = torch.cuda.max_memory_allocated()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hm.get_implausibility(0.0, 1)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    print("phase 6: HistoryMatching sweep of {} coords x {} outputs (rank 1) on {}: coords drawn "
          "in {} s; get_implausibility {} s wall, {} ms device span (CUDA events), {} ms device "
          "busy (torch.profiler, a second run); predict_fused launches {}, kernel_matrix launches "
          "{}; peak device memory {} GB; {} points/s".format(
              N_SWEEP, N_OUTPUTS, label, coords_s, wall_s, start.elapsed_time(end), busy_ms,
              fused, k1, peak / 1e9, N_SWEEP / wall_s))
    if I.shape != (N_SWEEP,) or not np.isfinite(I).all():
        raise AssertionError("the sweep's implausibilities are not finite of shape (N_SWEEP,)")
    if fused <= 0 or k1 != 0:
        raise AssertionError("the sweep did not launch predict_fused, or launched kernel_matrix")

    nroy, ro = np.asarray(hm.get_NROY(), dtype=np.int64), np.asarray(hm.get_RO(), dtype=np.int64)
    keep["sweep"] = dict(mgp=mgp, obs=obs, coords=coords, I=I, nroy=nroy)
    count = np.zeros(N_SWEEP, dtype=np.int8)
    np.add.at(count, nroy, 1)
    np.add.at(count, ro, 1)
    if not (count == 1).all():
        raise AssertionError("NROY and RO do not partition the coords")

    saved = thm._DEVICE_SWEEP_MIN_COORDS
    thm._DEVICE_SWEEP_MIN_COORDS = N_SWEEP + 1  # the host path, on the card
    try:
        t0 = time.perf_counter()
        I_host = mogp_tpu_torch.HistoryMatching(
            gp=mgp, obs=obs, coords=coords[:N_SWEEP_HOST]).get_implausibility(0.0, 1)
        host_s = time.perf_counter() - t0
    finally:
        thm._DEVICE_SWEEP_MIN_COORDS = saved
    d_host = float(np.max(np.abs(I[:N_SWEEP_HOST] - I_host) / I_host))

    t0 = time.perf_counter()
    ref = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    ref.fit(thetas)
    I_cpu = mogp_tpu_torch.HistoryMatching(
        gp=ref, obs=obs, coords=coords[:N_CHECK]).get_implausibility(0.0, 1)
    d_cpu = float(np.max(np.abs(I[:N_CHECK] - I_cpu) / I_cpu))
    ok = d_host <= SWEEP_HOST_RTOL and d_cpu <= UQ_TOL["I_rel"]
    print("phase 6: the first {} coords by the host path on the card ({} s): max rel d I {} "
          "(limit {}); the first {} against float64 on the CPU ({} s): max rel d I {} (limit "
          "{}); NROY {} RO {}: {}".format(
              N_SWEEP_HOST, host_s, d_host, SWEEP_HOST_RTOL, N_CHECK,
              time.perf_counter() - t0, d_cpu, UQ_TOL["I_rel"], nroy.size, ro.size,
              "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the device sweep disagrees with the host path or float64")

    # standardized emulators: the sweep maps the observations into their
    # units, the host path maps the predictions back; both on the card
    std = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", standardize=True, device="cuda")
    std.fit(thetas)
    saved = thm._DEVICE_SWEEP_MIN_COORDS
    I_std = []
    try:
        for threshold in (1, N_SWEEP_HOST + 1):  # the device sweep, then the host path
            thm._DEVICE_SWEEP_MIN_COORDS = threshold
            I_std.append(mogp_tpu_torch.HistoryMatching(
                gp=std, obs=obs, coords=coords[:N_SWEEP_HOST]).get_implausibility(0.0, 1))
    finally:
        thm._DEVICE_SWEEP_MIN_COORDS = saved
    d_std = float(np.max(np.abs(I_std[0] - I_std[1]) / I_std[1]))
    print("phase 6: standardize=True, the first {} coords, the device sweep against the host path "
          "on the card: max rel d I {} (limit {}): {}".format(
              N_SWEEP_HOST, d_std, SWEEP_HOST_RTOL, "ok" if d_std <= SWEEP_HOST_RTOL else "FAIL"))
    if not d_std <= SWEEP_HOST_RTOL:
        raise AssertionError("the device sweep of standardized emulators disagrees with the host "
                             "path")

    # validation: full-covariance predictions through K1, pivoted on the card
    km.launches = pf.launches = 0
    t0 = time.perf_counter()
    se = validation.standard_errors(mgp, xv, yv)
    pe = validation.pivoted_errors(mgp, xv, yv)
    ms = validation.mahalanobis(mgp, xv, yv, scaled=True)
    val_s = time.perf_counter() - t0
    val_k1 = km.launches
    t0 = time.perf_counter()
    se_ref = validation.standard_errors(ref, xv, yv)
    ms_ref = validation.mahalanobis(ref, xv, yv, scaled=True)
    pe_ref = validation.pivoted_errors(ref, xv, yv)
    ref_s = time.perf_counter() - t0
    d_z = float(np.max(np.abs(_unpermuted(se) - _unpermuted(se_ref))))
    d_m = float(np.max(np.abs(ms - ms_ref)))
    same_P = sum(bool(np.array_equal(a[1], b[1])) for a, b in zip(pe, pe_ref))
    ok = (val_k1 > 0 and d_z <= UQ_TOL["z"] and d_m <= UQ_TOL["mahal_scaled"]
          and np.isfinite(ms).all() and all(np.isfinite(e).all() for e, _ in pe))
    print("phase 6: validation of {} outputs at {} points on {}: {} s (kernel_matrix launches {}); "
          "float64 CPU {} s: max |d z| {} (limit {}), max |d scaled Mahalanobis| {} (limit {}); "
          "pivoted errors with the CPU's permutation {} of {}: {}".format(
              N_OUTPUTS, N_VALID, label, val_s, val_k1, ref_s, d_z, UQ_TOL["z"], d_m,
              UQ_TOL["mahal_scaled"], same_P, N_OUTPUTS, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("validation on the card disagrees with float64 or missed K1")

    # the pivot nugget: one duplicated input, the unfused route
    xp, yp = np.vstack([x, x[:1]]), np.append(y[0], y[0][0])
    km.launches = kb.launches = pf.launches = 0
    gpp = mogp_tpu_torch.GaussianProcess(xp, yp, nugget="pivot", device="cuda")
    gpp.fit(thetas[0])
    res = gpp.predict(coords[:N_CHECK])
    launches = (pf.launches, km.launches, kb.launches)
    cpu = mogp_tpu_torch.GaussianProcess(xp, yp, nugget="pivot", device="cpu")
    cpu.fit(thetas[0])
    d_lp = abs(gpp.current_logpost - cpu.current_logpost) / abs(cpu.current_logpost)
    ok = (launches[0] == 0 and launches[1] > 0 and launches[2] > 0 and d_lp <= PIVOT_LOGPOST_RTOL
          and np.isfinite(res.mean).all() and (res.unc >= 0).all())
    print("phase 6: GaussianProcess(nugget=\"pivot\") n={} (one row duplicated) on {}: rank {} "
          "(CPU {}), logpost {} vs float64 CPU {}: rel {} (limit {}); launches predict_fused {}, "
          "kernel_matrix {}, cholesky_batched {}: {}".format(
              N_POINTS + 1, label, int(gpp.Kinv.rank), int(cpu.Kinv.rank), gpp.current_logpost,
              cpu.current_logpost, d_lp, PIVOT_LOGPOST_RTOL, *launches, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the pivot-nugget emulator took the fused route or disagrees")
    print("phase 6: {} s".format(time.perf_counter() - t_phase))
    return fused


def _sampling_busy_share(run):
    """The idle share of the sampling segments of a short NUTS run
    ``run()``, which is run twice: the wall from the first run, the busy
    time from the second under ``torch.profiler`` (CUDA activity), which
    slows the host's launches but not the card's kernels.  The warmup before
    the segments, which also captures the potential's CUDA graph, is in
    neither.  Under the profiler, K2's counter must rise by the number of
    K2 kernels the profiler saw, replays of the graph included, or by at
    most 1 / K2_PROFILER_LOSS more (its activity records can drop a
    kernel).

    :returns: ``{"wall", "busy", "idle_share", "k2_counted",
        "k2_profiled"}`` (seconds, and launches of the profiled run).
    """
    import torch
    from mogp_tpu_torch.models import inference as tinf
    from mogp_tpu_torch.ops import cholesky_batched as kb
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    segment = tinf._nuts_sample_seg
    total = {"wall": 0.0, "busy": 0.0, "k2_counted": 0, "k2_profiled": 0}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = segment(*args, **kwargs)
        torch.cuda.synchronize()
        total["wall"] += time.perf_counter() - t0
        return out

    def profiled(*args, **kwargs):
        torch.cuda.synchronize()
        before = kb.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = segment(*args, **kwargs)
            torch.cuda.synchronize()
        total["k2_counted"] += kb.launches - before
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total["busy"] += sum(e.self_device_time_total for e in events) / 1e6
        total["k2_profiled"] += sum(e.count for e in events if "cholesky_batched_kernel" in e.key)
        return out

    try:
        for wrapper in (timed, profiled):
            tinf._nuts_sample_seg = wrapper
            run()
    finally:
        tinf._nuts_sample_seg = segment
    total["idle_share"] = 1.0 - total["busy"] / total["wall"]
    lost = total["k2_counted"] - total["k2_profiled"]
    if total["k2_counted"] <= 0 or not 0 <= lost <= total["k2_counted"] // K2_PROFILER_LOSS:
        raise AssertionError("K2's counter rose by {} where the profiler saw {} launches".format(
            total["k2_counted"], total["k2_profiled"]))
    return total


def _chain_figures(results, seconds, stats, k2):
    """The figures 7a and 7b print, from ``MCMCResult``s of one timed run."""
    import numpy as np

    ess = min(float(r.ess.min()) for r in results)
    return {
        "seconds": seconds,
        "min_ess_per_sec": ess / seconds,
        "min_ess": ess,
        "transitions_per_chain": stats["transitions"],
        "leapfrogs_per_transition": stats["leapfrogs"] / max(stats["transitions"], 1),
        "leapfrogs_per_sec": stats["leapfrogs"] / seconds,
        "lane_leapfrogs_per_sec": stats["lane_leapfrogs"] / seconds,
        "lane_utilization": stats["lane_utilization"],
        "host_syncs_per_transition": stats["syncs"] / max(stats["transitions"], 1),
        "divergent_share": float(np.mean([r.diverging.mean() for r in results])),
        "mean_accept": float(np.mean([r.accept_prob.mean() for r in results])),
        "max_rhat": float(max(r.rhat.max() for r in results)),
        "k2_launches": k2,
        "k2_launches_per_leapfrog": k2 / max(stats["leapfrogs"], 1),
    }


def phase_nuts(mogp_tpu_torch, km, kb, pf, label, keep):
    """7a, 7d and 7e (module doc, phase 7): NUTS, VI and predict_MCMC on
    bench.py's NUTS problem; returns the figures for the kernel line and
    keeps 7a's GP for phase 10."""
    import numpy as np
    import torch
    from mogp_tpu_torch.models import inference as tinf
    from mogp_tpu_torch.models.gp import take_lanes
    from mogp_tpu_torch.ops import hmc

    x, y = nuts_problem()
    np.random.seed(2)
    t0 = time.perf_counter()
    gp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cuda"), n_tries=4, maxiter=50)
    theta = gp.theta.get_data()
    keep["nuts_gp"] = gp
    print("phase 7a: MAP fit (4 restarts, maxiter=50) {} s".format(time.perf_counter() - t0))
    kw = dict(n_chains=NUTS_CHAINS, theta0=theta)
    tinf.sample_GP_MCMC(gp, n_samples=4, n_warmup=4, seed=0, **kw)  # warm-up
    torch.cuda.synchronize()
    km.launches = kb.launches = pf.launches = 0
    hmc.counters.reset()
    t0 = time.perf_counter()
    res = tinf.sample_GP_MCMC(gp, n_samples=NUTS_SAMPLES, n_warmup=NUTS_WARMUP, seed=1, **kw)
    torch.cuda.synchronize()
    fig = _chain_figures([res], time.perf_counter() - t0, hmc.counters.read(), kb.launches)
    short = _sampling_busy_share(lambda: tinf.sample_GP_MCMC(
        gp, n_samples=PROFILE_SAMPLES, n_warmup=PROFILE_WARMUP, seed=2, max_depth=PROFILE_DEPTH,
        **kw))
    print("phase 7a: sample_GP_MCMC {} chains x ({} + {}), n={}, D={}, nugget=fit, float32 on {}: "
          "{}".format(NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES, N_POINTS, N_DIM, label,
                      json.dumps(fig)))
    print("phase 7a: a short run (seed 2, max_depth {}), its {} sampling transitions after {} of "
          "warmup: {}".format(PROFILE_DEPTH, PROFILE_SAMPLES, PROFILE_WARMUP, json.dumps(short)))
    if fig["k2_launches"] <= 0:
        raise AssertionError("NUTS did not launch K2")
    ok = (np.all(np.isfinite(res.samples)) and fig["max_rhat"] < NUTS_RHAT
          and fig["divergent_share"] <= NUTS_DIVERGENT)
    print("phase 7a: max R-hat {} (limit {}), divergent share {} (limit {}): {}".format(
        fig["max_rhat"], NUTS_RHAT, fig["divergent_share"], NUTS_DIVERGENT,
        "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's NUTS chains did not mix or diverged")

    # the card's float32 potential against float64 on the CPU at the last
    # sample of every chain
    pts = torch.as_tensor(res.samples[:, -1])
    cpu = mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cpu")
    (u32, g32), (u64, g64) = [
        tinf.gp_potential(take_lanes(g._data, torch.zeros(len(pts), dtype=torch.int64,
                                                          device=g._device)),
                          g.kernel, g.nugget_type)(pts.to(g._device))
        for g in (gp, cpu)]
    u32, g32, u64, g64 = (t.cpu().numpy() for t in (u32, g32, u64, g64))
    d_u = float(np.max(np.abs(u32 - u64) / np.abs(u64)))
    d_g = np.max(np.abs(g32 - g64), axis=0) / np.sqrt(np.mean(g64**2, axis=0))
    ok = d_u <= POTENTIAL_TOL["value_rel"] and bool(np.all(d_g <= POTENTIAL_TOL["grad_rel"]))
    print("phase 7a: potential at {} recorded samples, float32 card vs float64 CPU: max rel d u "
          "{} (limit {}); per gradient component (the nugget's last), the largest |d| over the "
          "component's rms {} (limits {}): {}".format(
              len(pts), d_u, POTENTIAL_TOL["value_rel"], d_g.tolist(),
              POTENTIAL_TOL["grad_rel"], "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's float32 potential disagrees with float64")

    # 7d: VI on the same GP
    tinf.fit_GP_VI(gp, n_steps=5, theta0=theta, seed=0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vi = tinf.fit_GP_VI(gp, n_steps=VI_STEPS, theta0=theta, seed=1)
    vi_s = time.perf_counter() - t0
    rising = vi.elbo_trace[-50:].mean() > vi.elbo_trace[:50].mean()
    ok = bool(np.all(np.isfinite(vi.mean)) and rising)
    print("phase 7d: fit_GP_VI {} steps x 8 draws on {}: {} s = {} steps/s; ELBO mean of the "
          "first 50 steps {}, of the last 50 {}: {}".format(
              VI_STEPS, label, vi_s, VI_STEPS / vi_s, vi.elbo_trace[:50].mean(),
              vi.elbo_trace[-50:].mean(), "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("VI did not give a finite mean and a rising ELBO")
    fig["vi_steps_per_sec"] = VI_STEPS / vi_s

    # 7e: the posterior predictive of chains 0-1, thinned, at training
    # inputs moved by about one posterior correlation length
    samples = res.samples[:PRED_CHAINS]
    q = predict_queries(x, samples, N_CHECK)
    km.launches = kb.launches = pf.launches = 0
    t0 = time.perf_counter()
    mu, var = tinf.predict_MCMC(gp, samples, q, thin=PRED_THIN)
    pred_s = time.perf_counter() - t0
    launches = (pf.launches, kb.launches, km.launches)
    t0 = time.perf_counter()
    mu64, var64 = tinf.predict_MCMC(cpu, samples, q, thin=PRED_THIN)
    cpu_s = time.perf_counter() - t0
    d_mean = float(np.max(np.abs(mu - mu64)))
    d_var = float(np.max(np.abs(var - var64)))
    n_lanes = len(samples.reshape(-1, samples.shape[-1])[::PRED_THIN])
    # the queries see the data: the prior mean is 0 and the targets O(1)
    seen = float(np.max(np.abs(mu64)))
    ok = (launches[0] > 0 and launches[1] > 0 and d_mean <= PREDICT_TOL["mean"]
          and d_var <= PREDICT_TOL["var"] and np.all(var > 0) and seen > 0.1)
    print("phase 7e: predict_MCMC of {} samples (lanes) at {} queries on {}: {} s; launches "
          "predict_fused {}, K2 {}, K1 {}; float64 CPU ({} s): max |mean| {} (above 0.1), "
          "variance {} to {}; max |d mean| {} (limit {}), max |d var| {} (limit {}): {}".format(
              n_lanes, N_CHECK, label, pred_s, *launches, cpu_s, seen, float(var64.min()),
              float(var64.max()), d_mean, PREDICT_TOL["mean"], d_var, PREDICT_TOL["var"],
              "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("predict_MCMC missed a kernel or disagrees with float64")
    fig["predict_launches"] = {"predict_fused": launches[0], "k2": launches[1]}
    return fig


def phase_mogp_nuts(mogp_tpu_torch, kb, mgp, label):
    """7b: NUTS posteriors of every output of phase 4's MAP fit."""
    import numpy as np
    import torch
    from mogp_tpu_torch.models import inference as tinf
    from mogp_tpu_torch.ops import hmc

    torch.cuda.synchronize()
    kb.launches = 0
    hmc.counters.reset()
    t0 = time.perf_counter()
    results = tinf.sample_MOGP_MCMC(mgp, n_samples=MOGP_SAMPLES, n_warmup=MOGP_WARMUP,
                                    n_chains=MOGP_CHAINS, seed=1)
    torch.cuda.synchronize()
    fig = _chain_figures(results, time.perf_counter() - t0, hmc.counters.read(), kb.launches)
    short = _sampling_busy_share(lambda: tinf.sample_MOGP_MCMC(
        mgp, n_samples=PROFILE_SAMPLES, n_warmup=PROFILE_WARMUP, n_chains=MOGP_CHAINS, seed=2,
        max_depth=PROFILE_DEPTH))
    share = float(np.mean([np.all(r.rhat < MOGP_RHAT) for r in results]))
    finite = all(np.all(np.isfinite(r.samples)) for r in results)
    ok = fig["k2_launches"] > 0 and finite and share >= MOGP_RHAT_SHARE
    print("phase 7b: sample_MOGP_MCMC {} outputs x {} chains ({} lanes) x ({} + {}), n={}, D={}, "
          "nugget=adaptive, float32 on {}: {}; a short run (seed 2, max_depth {}), its {} "
          "sampling transitions after {} of warmup: {}; outputs with R-hat < {}: {} (limit {}), "
          "finite {}: {}".format(
              N_OUTPUTS, MOGP_CHAINS, N_OUTPUTS * MOGP_CHAINS, MOGP_WARMUP, MOGP_SAMPLES, N_POINTS,
              N_DIM, label, json.dumps(fig), PROFILE_DEPTH, PROFILE_SAMPLES, PROFILE_WARMUP,
              json.dumps(short), MOGP_RHAT, share, MOGP_RHAT_SHARE, finite,
              "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the multi-output NUTS run missed K2, diverged or did not mix")
    return fig


def phase_oracle(mogp_tpu_torch, label):
    """7c: NUTS in float64 on the card against the quadrature oracle of
    tests/test_inference.py:164-217, computed by the port on the CPU."""
    import numpy as np
    import torch
    from mogp_tpu_torch.models import gp as tgp
    from mogp_tpu_torch.models import inference as tinf
    from mogp_tpu_torch.models import priors as tpri

    t0 = time.perf_counter()
    cpu = oracle_problem(mogp_tpu_torch, tpri, device="cpu")
    pts = oracle_grid()
    nlp = []
    with torch.no_grad():
        for c0 in range(0, len(pts), 8192):
            chunk = torch.as_tensor(pts[c0:c0 + 8192])
            data = tgp.take_lanes(cpu._data, torch.zeros(len(chunk), dtype=torch.int64))
            nlp.append(tgp.gp_nlp(chunk, data, cpu.kernel, cpu.nugget_type,
                                  sparse_ladder=tinf._POTENTIAL_LADDER).numpy())
    mean_q, var_q, edge = quadrature_moments(pts, np.concatenate(nlp))
    if edge >= 1e-8:
        raise AssertionError("the quadrature grid does not contain the posterior")

    grid_s = time.perf_counter() - t0
    gp = oracle_problem(mogp_tpu_torch, tpri, device="cuda", dtype=torch.float64)
    np.random.seed(0)
    t0 = time.perf_counter()
    gp = mogp_tpu_torch.fit_GP_MAP(gp, n_tries=4, maxiter=100)
    print("phase 7c: the quadrature on the CPU {} s; MAP fit on the card (float64, 4 restarts, "
          "maxiter=100) {} s".format(grid_s, time.perf_counter() - t0))
    t0 = time.perf_counter()
    res = tinf.sample_GP_MCMC(gp, n_samples=ORACLE_SAMPLES, n_warmup=ORACLE_WARMUP,
                              n_chains=ORACLE_CHAINS, seed=3, theta0=gp.theta.get_data())
    sec = time.perf_counter() - t0
    s = res.samples.reshape(-1, gp.n_params)
    mcse = np.sqrt(var_q / np.maximum(res.ess, 1.0))
    d_mean = np.abs(s.mean(0) - mean_q)
    ok = (np.all(res.rhat < 1.05) and np.all(d_mean < 4.0 * mcse + 1e-3)
          and np.allclose(s.var(0), var_q, rtol=0.2, atol=0))
    print("phase 7c: quadrature oracle, {} chains x ({} + {}) in float64 on {}: {} s; R-hat {}; "
          "posterior mean {} vs quadrature {} (|d| {}, limit 4 MCSE + 1e-3 = {}); variance {} vs "
          "{} (rtol 0.2): {}".format(
              ORACLE_CHAINS, ORACLE_WARMUP, ORACLE_SAMPLES, label, sec, res.rhat.tolist(),
              s.mean(0).tolist(), mean_q.tolist(), d_mean.tolist(), (4.0 * mcse + 1e-3).tolist(),
              s.var(0).tolist(), var_q.tolist(), "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card's float64 NUTS misses the quadrature oracle")


def phase_smc(mogp_tpu_torch, km, kb, pf, label, keep):
    """7f: smc_history_match on phase 6's emulator and observations;
    returns its figures and keeps the emulator, the arguments and the
    result for phase 10."""
    import numpy as np
    import torch
    from mogp_tpu_torch.uq import history_matching as thm
    from mogp_tpu_torch.uq import smc as tsmc

    x, y = make_data(N_OUTPUTS)
    thetas = make_thetas()
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    mgp.fit(thetas)
    obs, _, _ = uq_problem()
    bounds = np.array([[0.0, 1.0]] * N_DIM)
    kw = dict(obs=obs, bounds=bounds, n_particles=SMC_PARTICLES, n_stages=SMC_STAGES,
              n_mcmc=SMC_MCMC, rank=1)
    mogp_tpu_torch.smc_history_match(mgp, **dict(kw, n_stages=1, n_mcmc=1), seed=0)  # warm-up
    torch.cuda.synchronize()
    km.launches = kb.launches = pf.launches = 0
    t0 = time.perf_counter()
    res = mogp_tpu_torch.smc_history_match(mgp, seed=1, **kw)
    wall = time.perf_counter() - t0
    fused, k1 = pf.launches, km.launches
    keep["smc"] = dict(mgp=mgp, kw=kw, seed=1, res=res)
    fig = {"seconds": wall, "fused_launches": fused,
           "fused_launches_per_stage": fused / SMC_STAGES}
    print("phase 7f: smc_history_match {} particles x {} outputs, {} stages x {} MH steps, rank 1, "
          "float32 on {}: {} s; predict_fused launches {} (kernel_matrix {}); thresholds {}; "
          "acceptance {}; nroy_fraction {}".format(
              SMC_PARTICLES, N_OUTPUTS, SMC_STAGES, SMC_MCMC, label, wall, fused, k1,
              res.thresholds.tolist(), res.accept_rates.tolist(), res.nroy_fraction))
    if fused <= 0 or res.particles.shape != (SMC_PARTICLES, N_DIM):
        raise AssertionError("SMC did not launch predict_fused or lost particles")

    # the final particles' I recomputed on the CPU in float64
    ref = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    ref.fit(thetas)
    I_fn = tsmc._make_implausibility_fn(ref, obs[0], obs[1], 0.0, True, rank=1)
    t0 = time.perf_counter()
    with torch.no_grad():
        I64 = np.concatenate([I_fn(torch.as_tensor(res.particles[c0:c0 + 8192])).numpy()
                              for c0 in range(0, SMC_PARTICLES, 8192)])
    d_I = np.abs(res.implausibility - I64) / I64
    near = int(np.sum(np.abs(I64 - 3.0) <= UQ_TOL["I_rel"] * 3.0))
    d_nroy = abs(int(np.sum(res.implausibility <= 3.0)) - int(np.sum(I64 <= 3.0)))
    ok = float(d_I.max()) <= UQ_TOL["I_rel"] and d_nroy <= near
    print("phase 7f: the final particles' I against float64 on the CPU ({} s): max rel d I {} "
          "(limit {}); NROY count card {} vs CPU {} (particles within the limit of the "
          "threshold: {}): {}".format(
              time.perf_counter() - t0, float(d_I.max()), UQ_TOL["I_rel"],
              int(np.sum(res.implausibility <= 3.0)), int(np.sum(I64 <= 3.0)), near,
              "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("SMC's implausibility disagrees with float64")

    # a standardized copy: SMC's I (observations mapped into the emulators'
    # units) against HistoryMatching's host path (predictions mapped back)
    std = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", standardize=True, device="cuda")
    std.fit(thetas)
    pts = res.particles[:SMC_STD_CHECK]
    I_std = tsmc._make_implausibility_fn(std, obs[0], obs[1], 0.0, True, rank=1)(
        std.emulators[0]._tensor(pts)).cpu().numpy()
    saved = thm._DEVICE_SWEEP_MIN_COORDS
    thm._DEVICE_SWEEP_MIN_COORDS = SMC_STD_CHECK + 1  # the host path
    try:
        I_host = mogp_tpu_torch.HistoryMatching(gp=std, obs=obs, coords=pts).get_implausibility(
            0.0, 1)
    finally:
        thm._DEVICE_SWEEP_MIN_COORDS = saved
    d_std = float(np.max(np.abs(I_std - I_host) / I_host))
    print("phase 7f: standardize=True, {} particles, SMC's implausibility against the host path "
          "on the card: max rel d I {} (limit {}): {}".format(
              SMC_STD_CHECK, d_std, SWEEP_HOST_RTOL, "ok" if d_std <= SWEEP_HOST_RTOL else "FAIL"))
    if not d_std <= SWEEP_HOST_RTOL:
        raise AssertionError("SMC's implausibility of standardized emulators disagrees")
    return fig


def phase_inference(mogp_tpu_torch, km, kb, pf, mgp, label, keep):
    """Phase 7 (module doc): 7a-7f; returns K2's launches per leapfrog (7a)
    and the fused kernel's per SMC stage (7f)."""
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(mogp_tpu_torch, *args)
        seconds[name] = time.perf_counter() - t0
        return out

    nuts = timed("7a 7d 7e", phase_nuts, km, kb, pf, label, keep)
    mogp = timed("7b", phase_mogp_nuts, kb, mgp, label)
    timed("7c", phase_oracle, label)
    smc = timed("7f", phase_smc, km, kb, pf, label, keep)
    print("phase 7: {} s; by part {}".format(time.perf_counter() - t_phase, json.dumps(seconds)))
    return {"7a": nuts["k2_launches_per_leapfrog"], "7b": mogp["k2_launches_per_leapfrog"]}, \
        smc["fused_launches_per_stage"]


# phase 8's limits: ten times mogp_tpu's own float32-vs-float64 gaps on a CPU
# for the same quantities (scripts/mice_reference_gap.py), each at the
# float32 run's own jitter rungs: the masked NLP on the one-rung ladder
# (relative; gap 1.33e-3); on a block of 4096 candidates, the base GP's
# variances (the largest difference over sigma2; 1.16e-5), the candidate
# GP's leave-one-out variances (relative; 2.01e-2), computed as the port
# does, 1 / [Q^-1]_ii from mogp_tpu's factor (mogp_tpu's own blockwise sum
# puts 99.8% of the block's float32 scores more than 50% off, and gives no
# limit), and the means (absolute, standardized units; 2.24e-3); 8c's
# fast_predict_all, the same way (relative; 5.13e-3), and the base GP's
# variances at its candidates (relative; 2.44e-4).  Each score s = unc1 /
# unc2 is held to the two parts' limits carried through the ratio, and the
# card's argmax to the sum of those limits at it and at the float64 argmax.
MICE_TOL = {"nlp_rel": 1.33e-2, "unc1_of_sigma2": 1.16e-4, "unc2_rel": 0.201, "mu_abs": 2.24e-2,
            "fast_predict_rel": 5.13e-2, "unc1_rel": 2.44e-3}


class _step_timer:
    """Within the block, ``mice_device``'s fit and score steps are timed
    (host clock, ending in a synchronize): ``split["fit"]`` and
    ``split["score"]`` hold a time per call."""

    def __init__(self, tmd):
        self.tmd = tmd
        self.split = {"fit": [], "score": []}

    def __enter__(self):
        import torch

        self.saved = self.tmd._mice_fit_step, self.tmd._mice_score_step

        def timed(name, fn):
            def wrapped(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                self.split[name].append(time.perf_counter() - t0)
                return out
            return wrapped

        self.tmd._mice_fit_step = timed("fit", self.saved[0])
        self.tmd._mice_score_step = timed("score", self.saved[1])
        return self

    def __exit__(self, *exc):
        self.tmd._mice_fit_step, self.tmd._mice_score_step = self.saved
        return False


def _mice_step_state(md):
    """The last acquisition step's buffers of the DeviceMICEDesign ``md``
    (run to its end): ``(x_buf, y_buf, mask, n_obs)`` in float64 numpy,
    targets standardized as that step had them."""
    import numpy as np

    n_obs = md.inputs.shape[0] - 1
    x_buf = np.tile(md.inputs[:1], (md.n_max, 1))
    x_buf[:n_obs] = md.inputs[:n_obs]
    y_buf = np.zeros(md.n_max)
    y_buf[:n_obs] = (md.targets[:n_obs] - md._t_mean) / md._t_std
    return x_buf, y_buf, (np.arange(md.n_max) < n_obs).astype(np.float64), n_obs


def _mice_parts(tmd, kernel, data, raw, mask, n_obs, blk, cmask, q_nugget, fast):
    """The two parts of one block's MICE scores, as the score step computes
    them, at a fixed base nugget (``data``'s) and ``q_nugget`` on the
    candidates' diagonal (the smoothing nugget ``fast`` and the rung's
    jitter): ``(unc1, unc2)``, float64 numpy ``(B,)``."""
    import torch
    from mogp_tpu_torch.ops.cholesky import ChoFactor, cholesky_factor, jit_cholesky
    from mogp_tpu_torch.uq.sequential_design import _loo_variances_all

    dtype, device = data.inputs.dtype, data.inputs.device
    D = blk.shape[-1]
    sigma2 = torch.exp(raw[:, D])
    K = sigma2[:, None, None] * kernel.kernel_f(data.inputs, data.inputs, raw[:, :D])
    Kinv, nug = cholesky_factor(tmd._masked_cov(K, mask), data.fixed_nugget, "fixed",
                                jitter_mask=mask)
    L = Kinv.L[:, :n_obs, :n_obs]
    alpha = ChoFactor(L).solve(data.targets[:, :n_obs])
    blk = torch.as_tensor(blk, dtype=dtype, device=device)
    cm = torch.as_tensor(cmask, dtype=dtype, device=device)
    _, unc1 = tmd._base_predict(kernel, data, raw, L, alpha, nug, blk[0])
    C = tmd._cand_cov(kernel, blk, cm, raw[:, :D], sigma2)
    Lq, jit = jit_cholesky(C + q_nugget * torch.diag_embed(cm), jitter_mask=cm)
    V = Lq.solve_L(torch.eye(blk.shape[1], dtype=dtype, device=device).expand_as(Lq.L))
    unc2 = _loo_variances_all(V, q_nugget - fast + jit[:, None])
    return tuple(t[0].to("cpu", torch.float64).numpy() for t in (unc1, unc2))


def phase_mice_device(mogp_tpu_torch, km, kb, kbl, pf, label, keep):
    """8a and 8b (module doc); returns the launches per acquisition step of
    K1, the fused prediction, K2 and the routed blocked variant, and keeps
    8a's chosen points for phase 10."""
    import numpy as np
    import torch
    from mogp_tpu_torch.models.gp import make_gp_data
    from mogp_tpu_torch.models.priors import GPPriors
    from mogp_tpu_torch.ops.cholesky import cholesky_factor, jit_cholesky
    from mogp_tpu_torch.uq import mice_device as tmd

    route = kb.route(MICE_BLOCK, torch.float32)
    if route not in kbl.VARIANTS or pf.route("cuda", MICE_INIT + MICE_SAMPLES, 0, "stationary",
                                             False, torch.float32) != "fused":
        raise AssertionError("the MICE blocks are not on a blocked route, or the base GP is not "
                             "on the fused one")
    md = mice_device_design(mogp_tpu_torch, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.launches = kb.launches = pf.launches = 0
    for v in kbl.VARIANTS:
        kbl.launches[v] = 0
    steps = []
    with forbid_cholesky_ex_on_cuda(), _step_timer(tmd) as timer:
        for i in range(MICE_SAMPLES):
            t0 = time.perf_counter()
            md.run_next_point()
            steps.append(time.perf_counter() - t0)
            print("phase 8a: step {}: {} s (fit {} s, score {} s), n_obs {}, chose {}".format(
                i, steps[-1], timer.split["fit"][-1], timer.split["score"][-1],
                md.inputs.shape[0] - 1, md.inputs[-1].tolist()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"kernel_matrix": km.launches, "predict_fused": pf.launches,
                "cholesky_batched": kb.launches, **{"cholesky_blocked_" + v: kbl.launches[v]
                                                    for v in kbl.VARIANTS}}
    keep["mice_inputs"] = md.inputs.copy()
    warm = steps[1:]
    fig = {"seconds_per_step_warm_median": float(np.median(warm)),
           "fit_seconds_warm_median": float(np.median(timer.split["fit"][1:])),
           "score_seconds_warm_median": float(np.median(timer.split["score"][1:])),
           "peak_gb": peak / 1e9,
           "launches_per_step": {k: v / MICE_SAMPLES for k, v in launches.items()}}
    print("phase 8a: DeviceMICEDesign, Branin, {} + {} points, {} candidates in blocks of {}, "
          "{} restarts x maxiter {}, float32 on {}: steps {} s; mice_seconds_per_step (warm "
          "median) {} s, fit {} s, score {} s; peak device memory {} GB; launches {}".format(
              MICE_INIT, MICE_SAMPLES, MICE_CAND, MICE_BLOCK, MICE_TRIES, MICE_MAXITER, label,
              steps, fig["seconds_per_step_warm_median"], fig["fit_seconds_warm_median"],
              fig["score_seconds_warm_median"], fig["peak_gb"], launches))
    lo, hi = np.array(MICE_BOUNDS).T
    if (launches["cholesky_batched"] == 0 or launches["predict_fused"] == 0
            or launches["cholesky_blocked_" + route] == 0
            or any(launches["cholesky_blocked_" + v] for v in kbl.VARIANTS if v != route)):
        raise AssertionError("8a did not launch K2, the fused prediction and the routed blocked "
                             "variant, or launched another blocked variant")
    if not (md.inputs.shape == (MICE_INIT + MICE_SAMPLES, 2) and np.all(md.inputs >= lo)
            and np.all(md.inputs <= hi) and np.all(np.isfinite(md.targets))
            and md.targets.shape == (MICE_INIT + MICE_SAMPLES,)):
        raise AssertionError("8a chose points outside the bounds, or a target is not finite")

    # 8b: the last step at the card's theta and rungs against float64 on the CPU
    t0 = time.perf_counter()
    x_buf, y_buf, mask, n_obs = _mice_step_state(md)
    raw = md.get_current_theta()
    D = x_buf.shape[1]
    sigma2 = float(np.exp(raw[D]))
    kernel = md._kernel
    priors = GPPriors.default_priors(md.inputs[:n_obs], D, nugget_type="adaptive")

    def on(device, **kw):
        """The step's buffers, theta and mask on ``device``."""
        data = make_gp_data(x_buf, y_buf, np.zeros((md.n_max, 0)), priors, device=device, **kw)
        return (data, torch.as_tensor(raw, dtype=data.inputs.dtype, device=device)[None],
                torch.as_tensor(mask, dtype=data.inputs.dtype, device=device))

    card, raw_c, mask_c = on("cuda")
    nlp_card = tmd.masked_gp_nlp(raw_c, card, mask_c, kernel, "adaptive",
                                 sparse_ladder="single").item()
    cpu, raw64, mask64 = on("cpu")
    nlp_cpu = tmd.masked_gp_nlp(raw64, cpu, mask64, kernel, "adaptive",
                                sparse_ladder="single").item()
    d_nlp = abs(nlp_card - nlp_cpu) / abs(nlp_cpu)

    # the card's rungs: the base factor's realized jitter and each checked
    # block's, computed as the score step computes them
    K = torch.exp(raw_c[:, D])[:, None, None] * kernel.kernel_f(card.inputs, card.inputs,
                                                                 raw_c[:, :D])
    _, nug = cholesky_factor(tmd._masked_cov(K, mask_c), torch.zeros(1, device="cuda"),
                             "adaptive", jitter_mask=mask_c)
    floor = 1e3 * float(torch.finfo(torch.float32).eps) * sigma2
    fast = torch.clamp_min(nug * md.nugget_s, floor)
    B = MICE_BLOCK
    cands = np.tile(md.candidates[:1], (md._n_cand_pad, 1))
    cands[:MICE_CAND] = md.candidates
    cmask = (np.arange(md._n_cand_pad) < MICE_CAND).astype(np.float64)
    best = md._last_index
    fixed = {dev: on(dev, nugget_value=nug.item()) for dev in ("cuda", "cpu")}
    ok = d_nlp <= MICE_TOL["nlp_rel"]
    for b in sorted({0, best // B}):
        sl = slice(b * B, min((b + 1) * B, MICE_CAND))
        n_real = sl.stop - sl.start
        blk, cm = cands[None, b * B:(b + 1) * B], cmask[None, b * B:(b + 1) * B]
        C = tmd._cand_cov(kernel, torch.as_tensor(blk, dtype=torch.float32, device="cuda"),
                          torch.as_tensor(cm, dtype=torch.float32, device="cuda"),
                          raw_c[:, :D], torch.exp(raw_c[:, D]))
        cm_c = torch.as_tensor(cm, dtype=torch.float32, device="cuda")
        _, jit = jit_cholesky(C + fast * torch.diag_embed(cm_c), jitter_mask=cm_c)
        del C
        q_nugget = fast.item() + jit.item()
        s64, m64 = tmd._mice_score_step(fixed["cpu"][1][0], fixed["cpu"][0], fixed["cpu"][2],
                                        torch.as_tensor(blk), torch.as_tensor(cm), q_nugget, 0.0,
                                        kernel, "fixed", True)
        s64, m64 = s64.numpy()[:n_real], m64.numpy()[:n_real]
        u1, u2 = (_mice_parts(tmd, kernel, *fixed[dev], n_obs, blk, cm, q_nugget, fast.item())
                  for dev in ("cuda", "cpu"))
        u1, u2 = ([p[:n_real] for p in parts] for parts in zip(u1, u2))
        d_u1 = float(np.max(np.abs(u1[0] - u1[1]))) / sigma2
        d_u2 = float(np.max(np.abs(u2[0] - u2[1]) / u2[1]))
        d_m = float(np.max(np.abs(md._last_mu[sl] - m64)))
        # each score against the float64 one, within the two parts' limits
        # carried through s = unc1 / unc2 to first order
        bound = MICE_TOL["unc1_of_sigma2"] * sigma2 / u2[1] + MICE_TOL["unc2_rel"] * s64
        use = np.abs(md._last_scores[sl] - s64) / bound
        ok_b = (d_u1 <= MICE_TOL["unc1_of_sigma2"] and d_u2 <= MICE_TOL["unc2_rel"]
                and d_m <= MICE_TOL["mu_abs"] and float(use.max()) <= 1.0)
        line = "phase 8b: block {} ({} candidates, the card's jitter {}): unc1 abs over sigma2 " \
               "{} (limit {}), unc2 rel {} (limit {}), mu abs {} (limit {}); scores {} to {}, the " \
               "largest difference {} ({} of the largest score), the largest share of its " \
               "propagated limit {} (limit 1)".format(
                   b, n_real, jit.item(), d_u1, MICE_TOL["unc1_of_sigma2"], d_u2,
                   MICE_TOL["unc2_rel"], d_m, MICE_TOL["mu_abs"], s64.min(), s64.max(),
                   float(np.max(np.abs(md._last_scores[sl] - s64))),
                   float(np.max(np.abs(md._last_scores[sl] - s64)) / s64.max()),
                   float(use.max()))
        if b == best // B:
            i, j = best - b * B, int(np.argmax(s64))
            regret = float((s64[j] - s64[i]) / s64[j])
            ok_b = ok_b and s64[j] - s64[i] <= bound[i] + bound[j]
            line += "; the card's argmax {}: float64 score {} vs the block's float64 maximum {} " \
                    "(regret {}, limit {})".format(best, s64[i], s64[j], regret,
                                                   float((bound[i] + bound[j]) / s64[j]))
        print(line + (" ok" if ok_b else " FAIL"))
        ok = ok and ok_b
    print("phase 8b: the last step against float64 on the CPU at the card's theta {}, base "
          "nugget {} and candidate nugget {}: masked NLP (one-rung ladder) {} vs {}, rel {} "
          "(limit {}); {} s {}".format(raw.tolist(), nug.item(), fast.item(), nlp_card, nlp_cpu,
                                      d_nlp, MICE_TOL["nlp_rel"], time.perf_counter() - t0,
                                      "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("8b: the card's MICE step disagrees with float64")
    return fig


def phase_mice_host(mogp_tpu_torch, kb, label):
    """8c (module doc)."""
    import numpy as np
    import torch

    md = mice_host_design(mogp_tpu_torch, device="cuda")
    torch.cuda.synchronize()
    kb.launches = 0
    worst = {"fast_predict_rel": 0.0, "unc1_rel": 0.0}
    t0 = time.perf_counter()
    with forbid_cholesky_ex_on_cuda():
        for i in range(MICE_HOST_SAMPLES):
            md.run_next_point()
            gp, fast = md.gp, md.gp_fast
            theta = gp.theta.get_data()
            unc1, unc2 = gp.predict(md.candidates)[1], fast.fast_predict_all()
            ref = mogp_tpu_torch.GaussianProcess(gp.inputs, gp.targets, nugget=float(gp.nugget),
                                                 device="cpu")
            ref.fit(theta)
            ref_fast = mogp_tpu_torch.MICEFastGP(md.candidates, np.ones(MICE_HOST_CAND),
                                                 nugget=float(fast.nugget), device="cpu")
            ref_fast.fit(theta[:ref_fast.n_params])
            unc1_64, unc2_64 = ref.predict(md.candidates)[1], ref_fast.fast_predict_all()
            d1 = float(np.max(np.abs(unc1 - unc1_64) / np.abs(unc1_64)))
            d2 = float(np.max(np.abs(unc2 - unc2_64) / np.abs(unc2_64)))
            worst["unc1_rel"] = max(worst["unc1_rel"], d1)
            worst["fast_predict_rel"] = max(worst["fast_predict_rel"], d2)
            print("phase 8c: step {}: theta {}, nugget {}, candidate nugget {}, chose {}; unc1 rel "
                  "{} (limit {}), fast_predict_all rel {} (limit {})".format(
                      i, theta.tolist(), gp.nugget, fast.nugget, md.inputs[-1].tolist(), d1,
                      MICE_TOL["unc1_rel"], d2, MICE_TOL["fast_predict_rel"]))
    torch.cuda.synchronize()
    ok = (worst["unc1_rel"] <= MICE_TOL["unc1_rel"]
          and worst["fast_predict_rel"] <= MICE_TOL["fast_predict_rel"] and kb.launches > 0
          and np.all(np.isfinite(md.targets)))
    print("phase 8c: MICEDesign, Branin, {} + {} points, {} candidates, float32 on {}: {} s, K2 "
          "launches {} {}".format(MICE_HOST_INIT, MICE_HOST_SAMPLES, MICE_HOST_CAND, label,
                                  time.perf_counter() - t0, kb.launches, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("8c: MICEDesign on the card disagrees with float64, or did not "
                             "launch K2")


def phase_mice(mogp_tpu_torch, km, kb, kbl, pf, label, keep):
    """Phase 8 (module doc); returns 8a's figures."""
    t0 = time.perf_counter()
    fig = phase_mice_device(mogp_tpu_torch, km, kb, kbl, pf, label, keep)
    t1 = time.perf_counter()
    phase_mice_host(mogp_tpu_torch, kb, label)
    print("phase 8: {} s (8a + 8b {} s, 8c {} s)".format(time.perf_counter() - t0, t1 - t0,
                                                        time.perf_counter() - t1))
    return fig


# phase 9's limits.  9a: the card's float64 gKDR against the port's on the
# CPU (the same function, K1's direct differences against the plain
# version's matmul form; cond(Kx + N EPS I) ~ 1e8 magnifies their last
# ulps); the fit: phase 4's gate.  9b, 9c: ten times mogp_tpu's own
# float32-vs-float64 gap on the CPU for the same quantities
# (scripts/gkdr_reference_gap.py): each K's loss relative (its float32
# gKDR cannot resolve N EPS = 8e-7, so its losses are 31-98% off), each
# kernel's derivative and Hessian as the largest difference over the
# largest entry.
GKDR_TOL = {"evals_rel": 1e-9, "projector": 1e-8}
KDR_LOSS_TOL = [3.133, 9.846, 7.451]
DERIV_TOL = {
    "SquaredExponential": (1.109e-5, 1.845e-5), "Matern52": (1.204e-5, 4.198e-5),
    "UniformSqExp": (2.592e-5, 3.086e-5), "UniformMat52": (5.260e-5, 8.706e-5),
    "ProductMat52": (5.393e-6, 6.817e-6),
}
# phase 10: the mesh.  10a: auto_mesh() on the card; 10b: one card named
# MESH_SHARDS times, which drives every path's split and merge (the shards
# run one after another).  The sweep, SMC and the NUTS chains are held to
# the unsharded runs of phases 6, 7f and an unsharded run here: I and the
# particles within MESH_RTOL relative (the same float32 kernels on other
# batch sizes), the NROY set equal; the NUTS chains' pooled mean of every
# parameter within NUTS_MESH_MCSE times the two runs' combined Monte Carlo
# standard error (sd / sqrt(ESS)): a tree decision that rounding flips
# sends a chain down another trajectory, after which the two runs are two
# draws from one posterior; 10b's NUTS: 8 chains, 20 + 20, trees of at most
# 2**NUTS_MESH_DEPTH - 1 leapfrogs (cut from 8 to keep the four shards'
# turns short).  MICE: 2 steps of 8a, the same chosen points.
MESH_SHARDS, MESH_RTOL = 4, 1e-6
NUTS_MESH_CHAINS, NUTS_MESH_ITERS, NUTS_MESH_DEPTH, NUTS_MESH_MCSE, NUTS_MESH_SEED = \
    8, 20, 6, 4.0, 3
MICE_MESH_STEPS = 2


def _ref_gkdr_fit():
    """9a's gKDR by the port in float64 on the CPU, and the MAP fit of the
    first N_QUALITY outputs on its reduced inputs, seeded as on the card
    (a worker process); ``(B, evals, NLPs)``."""
    import numpy as np
    import torch
    import mogp_tpu_torch

    torch.set_num_threads(4)
    X, Y, _ = kdr_demo_problem(mogp_tpu_torch)
    dr = mogp_tpu_torch.gKDR(X, Y[0], K=KDR_D_ACTIVE, device="cpu")
    np.random.seed(KDR_SEED)
    mgp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.MultiOutputGP(dr(X), Y[:N_QUALITY], nugget="adaptive", device="cpu"),
        n_tries=N_TRIES, maxiter=MAXITER)
    return dr.B, dr.evals, np.array([em.current_logpost for em in mgp.emulators])


def _ref_kdr_bench():
    """9b's losses in float64 on the CPU (a worker process)."""
    import torch
    import mogp_tpu_torch

    torch.set_num_threads(2)
    return kdr_bench_losses(mogp_tpu_torch, device="cpu")


def _ref_derivs():
    """9c's derivatives and Hessians in float64 on the CPU (a worker
    process), by kernel name."""
    import torch
    from mogp_tpu_torch.ops.kernels import get_kernel

    torch.set_num_threads(2)
    out = {}
    for name in KERNEL_NAMES:
        kernel = get_kernel(name)
        x, theta = deriv_problem(kernel)
        out[name] = (kernel.kernel_deriv(x, x, theta).numpy(),
                     kernel.kernel_hessian(x, x, theta).numpy())
    return out


def cpu_references(pool):
    """Start phase 9's float64 CPU references in the worker processes of
    ``pool``; they run while the card runs phases 9 and 10."""
    return {"9a": pool.submit(_ref_gkdr_fit), "9b": pool.submit(_ref_kdr_bench),
            "9c": pool.submit(_ref_derivs)}


def _zero(km, kb, kbl, pf):
    km.launches = kb.launches = pf.launches = 0
    for v in kbl.VARIANTS:
        kbl.launches[v] = 0


def _launches(km, kb, kbl, pf):
    """The launch counters, by the kernel line's names."""
    return {"kernel_matrix": km.launches, "predict_fused": pf.launches,
            "cholesky_batched": kb.launches,
            **{"cholesky_blocked_" + v: kbl.launches[v] for v in kbl.VARIANTS}}


def _quality(mogp_tpu_torch, inputs, targets, mgp, nlp_cpu):
    """Phase 4's gate: the card's winners of the first N_QUALITY outputs
    re-evaluated in float64 on the CPU against the float64 CPU fit's NLPs;
    ``(gap, ok)``."""
    import numpy as np

    card = mogp_tpu_torch.MultiOutputGP(inputs, targets[:N_QUALITY], nugget="adaptive",
                                        device="cpu")
    card.fit([em.theta.get_data() for em in mgp.emulators[:N_QUALITY]])
    nlp_card = np.array([em.current_logpost for em in card.emulators])
    gap = float(np.mean(nlp_card - nlp_cpu))
    return gap, bool(np.isfinite(nlp_card).all()) and gap <= NLP_GAP


def phase_gkdr(mogp_tpu_torch, km, kb, kbl, pf, label):
    """9a on the card (module doc): gKDR at the calibration demo's width and
    the 100-output fit on the reduced inputs; returns the launches and the
    check against the CPU references, which runs once they are ready."""
    import numpy as np
    import torch
    from mogp_tpu_torch.uq import dimension_reduction as tdr

    X, Y, w = kdr_demo_problem(mogp_tpu_torch)
    route = kb.route(KDR_N, torch.float64)
    route = "cholesky_batched" if route == "k2" else "cholesky_blocked_" + route
    mogp_tpu_torch.gKDR(X, Y[0], K=KDR_D_ACTIVE, device="cuda")  # warm-up
    torch.cuda.synchronize()
    _zero(km, kb, kbl, pf)
    walls = []
    with forbid_cholesky_ex_on_cuda():
        for _ in range(3):
            t0 = time.perf_counter()
            dr = mogp_tpu_torch.gKDR(X, Y[0], K=KDR_D_ACTIVE, device="cuda")
            walls.append(time.perf_counter() - t0)
    per_gkdr = {k: v / 3 for k, v in _launches(km, kb, kbl, pf).items()}

    # the parts, by CUDA events around each step of the projection
    Xt = torch.as_tensor(X, device="cuda")
    Yt = torch.as_tensor(Y[0].reshape(-1, 1), device="cuda")
    s2x, s2y = tdr.median_dist(X) ** 2, tdr.median_dist(Y[0].reshape(-1, 1)) ** 2
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.no_grad():
        ev[0].record()
        Kx, Ky = tdr._grams(Xt, Yt, s2x, s2y)
        ev[1].record()
        L = tdr._factor(Kx, 1e-8)
        ev[2].record()
        F = tdr._solves(L, Ky)
        ev[3].record()
        R = tdr._contraction(Xt, Kx, F, s2x)
        ev[4].record()
        tdr._eig(R)
        ev[5].record()
    ev[5].synchronize()
    parts = dict(zip(["grams_k1", "factor", "solves", "contraction", "eigh"],
                     [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]))
    overlap = np.linalg.svd(dr.B[:, :KDR_D_ACTIVE].T @ w)[1]
    print("phase 9a: gKDR(X {}, Y[0], K={}), float64 on {}: warm wall {} s (median of "
          "{}); parts by CUDA events {} ms; launches per gKDR {} (route at n = {}: {}); evals "
          "{} ...; subspace overlap (singular values of B[:, :3]^T w) {}".format(
              X.shape, KDR_D_ACTIVE, label, float(np.median(walls)), walls, json.dumps(parts),
              per_gkdr, KDR_N, route,
              dr.evals[:5].tolist(), overlap.tolist()))
    if per_gkdr["kernel_matrix"] != 2 or per_gkdr[route] != 1:
        raise AssertionError("9a: gKDR did not launch K1 twice and its Cholesky route once")

    Xr = dr(X)
    _zero(km, kb, kbl, pf)
    np.random.seed(KDR_SEED)
    t0 = time.perf_counter()
    with forbid_cholesky_ex_on_cuda():
        mgp = mogp_tpu_torch.fit_GP_MAP(
            mogp_tpu_torch.MultiOutputGP(Xr, Y, nugget="adaptive", device="cuda"),
            n_tries=N_TRIES, maxiter=MAXITER)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = _launches(km, kb, kbl, pf)
    n_fit = len(mgp.get_indices_fit())
    print("phase 9a: fit_GP_MAP of {} outputs x {} restarts on the reduced inputs (n={}, D={}), "
          "maxiter={}, float32 on {}: {} s; outputs fit {}; launches {}".format(
              KDR_OUTPUTS, N_TRIES, KDR_N, KDR_D_ACTIVE, MAXITER, label, fit_s, n_fit,
              fit_launches))
    if n_fit != KDR_OUTPUTS or fit_launches["cholesky_batched"] <= 0:
        raise AssertionError("9a: the fit on the reduced inputs left outputs unfit or did not "
                             "launch K2")

    def check(ref):
        B64, evals64, nlp_cpu = ref
        d_evals = float(np.max(np.abs(dr.evals - evals64)) / np.max(np.abs(evals64)))
        P = dr.B[:, :KDR_D_ACTIVE] @ dr.B[:, :KDR_D_ACTIVE].T
        d_proj = float(np.max(np.abs(P - B64[:, :KDR_D_ACTIVE] @ B64[:, :KDR_D_ACTIVE].T)))
        # the CPU's fit ran on the CPU's own projection, the same inputs to
        # d_proj: the card's winners are re-evaluated on the card's
        gap, fit_ok = _quality(mogp_tpu_torch, Xr, Y, mgp, nlp_cpu)
        ok = d_evals <= GKDR_TOL["evals_rel"] and d_proj <= GKDR_TOL["projector"] and fit_ok
        print("phase 9a: vs float64 on the CPU: max |d evals| / max evals {} (limit {}), rank-3 "
              "projector max |d| {} (limit {}); the fit's quality on the first {} outputs: mean "
              "NLP gap {} (limit {}): {}".format(
                  d_evals, GKDR_TOL["evals_rel"], d_proj, GKDR_TOL["projector"], N_QUALITY, gap,
                  NLP_GAP, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("9a: the card's gKDR or its fit disagrees with float64")

    return {"per_gkdr": per_gkdr, "fit": fit_launches}, check


def phase_kdr_bench(mogp_tpu_torch, km, kb, kbl, pf, label):
    """9b on the card (module doc): benchmark_kdr_GP.py's loss curve;
    returns the launches and the check against float64 on the CPU."""
    import numpy as np

    _zero(km, kb, kbl, pf)
    t0 = time.perf_counter()
    with forbid_cholesky_ex_on_cuda():
        losses = kdr_bench_losses(mogp_tpu_torch, device="cuda")
    wall = time.perf_counter() - t0
    launches = _launches(km, kb, kbl, pf)
    best = KDR_BENCH_KS[int(np.argmin(losses))]
    print("phase 9b: benchmark_kdr_GP.py (N = M = {}, {} folds, K {}), gKDR float64 and the GP "
          "fits float32 on {}: {} s; losses {}; argmin K {} (expected 1); launches {}".format(
              KDR_BENCH_N, KDR_BENCH_FOLDS, list(KDR_BENCH_KS), label, wall, losses, best,
              launches))
    if (best != 1 or launches["cholesky_batched"] <= 0
            or launches["kernel_matrix"] != 2 * KDR_BENCH_FOLDS * len(KDR_BENCH_KS)):
        raise AssertionError("9b: the loss curve's argmin is not 1, or K1 and K2 did not launch")

    def check(ref):
        d = np.abs(np.array(losses) - np.array(ref)) / np.abs(np.array(ref))
        ok = bool(np.all(d <= KDR_LOSS_TOL))
        print("phase 9b: losses float64 on the CPU {}; rel d {} (limits {}): {}".format(
            ref, d.tolist(), KDR_LOSS_TOL, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("9b: the loss curve disagrees with float64")

    return launches, check


def phase_derivs(mogp_tpu_torch, label):
    """9c on the card (module doc): kernel_deriv and kernel_hessian of the
    five kernels in float32; returns the check against float64 on the
    CPU."""
    import numpy as np
    import torch
    from mogp_tpu_torch.ops.kernels import get_kernel

    got = {}
    for name in KERNEL_NAMES:
        kernel = get_kernel(name)
        x, theta = deriv_problem(kernel)
        xc = torch.as_tensor(x, dtype=torch.float32, device="cuda")
        tc = torch.as_tensor(theta, dtype=torch.float32, device="cuda")
        kernel.kernel_hessian(xc, xc, tc)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = kernel.kernel_deriv(xc, xc, tc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = kernel.kernel_hessian(xc, xc, tc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got[name] = d.cpu().numpy(), h.cpu().numpy()
        idx = np.arange(len(x))
        zero_ok = bool(np.isfinite(got[name][0]).all() and np.isfinite(got[name][1]).all()
                       and not np.any(got[name][0][:, idx, idx])
                       and not np.any(got[name][1][:, :, idx, idx]))
        print("phase 9c: {} at ({}, {}) with {} parameters, float32 on {}: kernel_deriv {} s, "
              "kernel_hessian {} s; finite, and exactly 0 at zero distance: {}".format(
                  name, len(x), len(x), len(theta), label, t1 - t0, t2 - t1, zero_ok))
        if not zero_ok:
            raise AssertionError("9c: {}'s derivatives are not finite, or not 0 at zero "
                                 "distance".format(name))

    def check(ref):
        ok_all = True
        for name in KERNEL_NAMES:
            (d, h), (d64, h64) = got[name], ref[name]
            e_d = float(np.max(np.abs(d - d64)) / np.max(np.abs(d64)))
            e_h = float(np.max(np.abs(h - h64)) / np.max(np.abs(h64)))
            ok = e_d <= DERIV_TOL[name][0] and e_h <= DERIV_TOL[name][1]
            ok_all = ok_all and ok
            print("phase 9c: {} vs float64 on the CPU, max |d| / max: deriv {} (limit {}), "
                  "hessian {} (limit {}): {}".format(name, e_d, DERIV_TOL[name][0], e_h,
                                                     DERIV_TOL[name][1], "ok" if ok else "FAIL"))
        if not ok_all:
            raise AssertionError("9c: the card's kernel derivatives disagree with float64")

    return check


def phase_dimred(mogp_tpu_torch, km, kb, kbl, pf, label):
    """Phase 9 on the card (module doc): 9a-9c; returns the launches and
    the checks against the CPU references, by part."""
    t0 = time.perf_counter()
    out, check_a = phase_gkdr(mogp_tpu_torch, km, kb, kbl, pf, label)
    t1 = time.perf_counter()
    out["9b"], check_b = phase_kdr_bench(mogp_tpu_torch, km, kb, kbl, pf, label)
    t2 = time.perf_counter()
    check_c = phase_derivs(mogp_tpu_torch, label)
    print("phase 9 on the card: {} s (9a {} s, 9b {} s, 9c {} s)".format(
        time.perf_counter() - t0, t1 - t0, t2 - t1, time.perf_counter() - t2))
    return out, {"9a": check_a, "9b": check_b, "9c": check_c}


def _mesh_fit(mogp_tpu_torch, km, kb, kbl, pf, mesh, keep, label, tag):
    """10a / 10b's fit: phase 4's configuration under ``mesh``, phase 4's
    gate; returns the launches."""
    import numpy as np
    import torch

    x, y = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    _zero(km, kb, kbl, pf)
    np.random.seed(1)
    t0 = time.perf_counter()
    with forbid_cholesky_ex_on_cuda():
        mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=MAXITER, mesh=mesh)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(km, kb, kbl, pf)
    n_fit = len(mgp.get_indices_fit())
    same = sum(np.array_equal(em.theta.get_data(), t)
               for em, t in zip(mgp.emulators, keep["fit_thetas"]))
    gap, ok = _quality(mogp_tpu_torch, x, y, mgp, keep["fit_nlp_cpu"])
    ok = ok and n_fit == N_OUTPUTS and launches["cholesky_batched"] > 0
    print("phase {}: fit_GP_MAP({} outputs x {} restarts, maxiter={}, mesh={}) float32 on {}: {} s; "
          "outputs fit {}; theta bit-identical to phase 4's unsharded fit for {} of {} outputs; "
          "phase 4's gate: mean NLP gap {} (limit {}); launches {}: {}".format(
              tag, N_OUTPUTS, N_TRIES, MAXITER, mesh, label, fit_s, n_fit, same, N_OUTPUTS,
              gap, NLP_GAP, launches, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("{}: the sharded fit failed phase 4's gate or did not launch "
                             "K2".format(tag))
    return launches


def phase_mesh(mogp_tpu_torch, km, kb, kbl, pf, label, keep):
    """Phase 10 (module doc): 10a a mesh of the card, 10b four shards of it;
    returns the launches of each path."""
    import numpy as np
    import torch
    from mogp_tpu_torch.parallel import DeviceMesh, auto_mesh

    t_phase = time.perf_counter()
    out = {}
    mesh = auto_mesh()
    if mesh.shape != {"outputs": 1} or mesh.devices != [torch.device("cuda", 0)]:
        raise AssertionError("auto_mesh() on one card is {}".format(mesh))
    out["10a_fit"] = _mesh_fit(mogp_tpu_torch, km, kb, kbl, pf, mesh, keep, label, "10a")

    mesh = DeviceMesh([torch.device("cuda:0")] * MESH_SHARDS)
    if mesh.threaded:
        raise AssertionError("one card named {} times must run its shards in turn".format(
            MESH_SHARDS))
    out["10b_fit"] = _mesh_fit(mogp_tpu_torch, km, kb, kbl, pf, mesh, keep, label, "10b")

    # the sweep over phase 6's 10^7 coords
    sw = keep["sweep"]
    hm = mogp_tpu_torch.HistoryMatching(gp=sw["mgp"], obs=sw["obs"], coords=sw["coords"],
                                        mesh=mesh)
    _zero(km, kb, kbl, pf)
    t0 = time.perf_counter()
    I = hm.get_implausibility(0.0, 1)
    wall = time.perf_counter() - t0
    out["10b_sweep"] = launches = _launches(km, kb, kbl, pf)
    d_I = float(np.max(np.abs(I - sw["I"]) / sw["I"]))
    same_nroy = np.array_equal(np.asarray(hm.get_NROY(), dtype=np.int64), sw["nroy"])
    ok = (d_I <= MESH_RTOL and same_nroy and launches["predict_fused"] > 0
          and launches["kernel_matrix"] == 0)
    print("phase 10b: HistoryMatching sweep of {} coords over {}: {} s; vs phase 6's unsharded I: "
          "max rel d {} (limit {}), bit-identical {}, the same NROY set ({} points) {}; launches "
          "{}: {}".format(N_SWEEP, mesh, wall, d_I, MESH_RTOL, bool(np.array_equal(I, sw["I"])),
                          len(sw["nroy"]), same_nroy, launches, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("10b: the sharded sweep disagrees with the unsharded one")

    # SMC at 7f's configuration and seed
    smc = keep["smc"]
    _zero(km, kb, kbl, pf)
    t0 = time.perf_counter()
    res = mogp_tpu_torch.smc_history_match(smc["mgp"], seed=smc["seed"], mesh=mesh, **smc["kw"])
    wall = time.perf_counter() - t0
    out["10b_smc"] = launches = _launches(km, kb, kbl, pf)
    ref = smc["res"]
    d_p = float(np.max(np.abs(res.particles - ref.particles)) / np.max(np.abs(ref.particles)))
    d_I = float(np.max(np.abs(res.implausibility - ref.implausibility) / ref.implausibility))
    ok = d_p <= MESH_RTOL and d_I <= MESH_RTOL and launches["predict_fused"] > 0
    print("phase 10b: smc_history_match ({} particles, {} stages) over {}: {} s; vs 7f's unsharded "
          "run: particles max |d| / max {} , I max rel d {} (limit {}); bit-identical particles "
          "{}; launches {}: {}".format(
              SMC_PARTICLES, SMC_STAGES, mesh, wall, d_p, d_I, MESH_RTOL,
              bool(np.array_equal(res.particles, ref.particles)), launches,
              "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("10b: sharded SMC disagrees with the unsharded run")

    # NUTS: 8 chains, unsharded and over the mesh
    gp = keep["nuts_gp"]
    kw = dict(n_chains=NUTS_MESH_CHAINS, n_samples=NUTS_MESH_ITERS, n_warmup=NUTS_MESH_ITERS,
              seed=NUTS_MESH_SEED, max_depth=NUTS_MESH_DEPTH, theta0=gp.theta.get_data())
    t0 = time.perf_counter()
    ref = mogp_tpu_torch.sample_GP_MCMC(gp, **kw)
    t1 = time.perf_counter()
    _zero(km, kb, kbl, pf)
    res = mogp_tpu_torch.sample_GP_MCMC(gp, mesh=mesh, **kw)
    t2 = time.perf_counter()
    out["10b_nuts"] = launches = _launches(km, kb, kbl, pf)
    s, s0 = res.samples, ref.samples
    mean, mean0 = s.mean(axis=(0, 1)), s0.mean(axis=(0, 1))
    sd = np.sqrt(0.5 * (s.reshape(-1, s.shape[-1]).var(axis=0)
                        + s0.reshape(-1, s0.shape[-1]).var(axis=0)))
    mcse = sd * np.sqrt(1.0 / np.maximum(res.ess, 1.0) + 1.0 / np.maximum(ref.ess, 1.0))
    z = np.abs(mean - mean0) / mcse
    same = [bool(np.array_equal(s[c], s0[c])) for c in range(NUTS_MESH_CHAINS)]
    ok = (bool(np.isfinite(s).all()) and float(z.max()) <= NUTS_MESH_MCSE
          and launches["cholesky_batched"] > 0)
    print("phase 10b: sample_GP_MCMC {} chains x ({} + {}), max_depth {}, over {}: {} s "
          "(unsharded {} s); chains bit-identical to the unsharded run {} of {}; max |d sample| "
          "{}; pooled means' |d| / combined MCSE max {} (limit {}); launches {}: {}".format(
              NUTS_MESH_CHAINS, NUTS_MESH_ITERS, NUTS_MESH_ITERS, NUTS_MESH_DEPTH, mesh, t2 - t1,
              t1 - t0, sum(same), NUTS_MESH_CHAINS, float(np.max(np.abs(s - s0))),
              float(z.max()), NUTS_MESH_MCSE, launches, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("10b: sharded NUTS chains are not finite or disagree with the "
                             "unsharded run")

    # MICE: 2 steps of 8a, the candidate blocks split over the mesh
    md = mice_device_design(mogp_tpu_torch, device="cuda", mesh=mesh)
    _zero(km, kb, kbl, pf)
    t0 = time.perf_counter()
    with forbid_cholesky_ex_on_cuda():
        for _ in range(MICE_MESH_STEPS):
            md.run_next_point()
    wall = time.perf_counter() - t0
    out["10b_mice"] = launches = _launches(km, kb, kbl, pf)
    chosen = md.inputs[MICE_INIT:MICE_INIT + MICE_MESH_STEPS]
    ref = keep["mice_inputs"][MICE_INIT:MICE_INIT + MICE_MESH_STEPS]
    route = kb.route(MICE_BLOCK, torch.float32)
    route = "cholesky_batched" if route == "k2" else "cholesky_blocked_" + route
    ok = (np.array_equal(chosen, ref) and launches["kernel_matrix"] > 0
          and launches["predict_fused"] > 0 and launches[route] > 0)
    print("phase 10b: DeviceMICEDesign, {} steps of 8a over {} ({} blocks padded to {}): {} s; "
          "chose {}, 8a's unsharded steps {}; launches {}: {}".format(
              MICE_MESH_STEPS, mesh, -(-MICE_CAND // MICE_BLOCK), md._n_cand_pad // MICE_BLOCK,
              wall, chosen.tolist(), ref.tolist(), launches, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("10b: sharded MICE chose other points, or a kernel did not launch")
    print("phase 10: {} s; one card, so no speedup from several cards is measured".format(
        time.perf_counter() - t_phase))
    return out


# phase 11: phase 4's fit in PROC_WORKERS processes on the one card, joined
# by init_distributed; the workers must end within PROC_DEADLINE seconds.
# Then sample_MOGP_MCMC of the fit across the processes: PROC_CHAINS chains
# an output, PROC_ITERS + PROC_ITERS, trees of at most 2**PROC_DEPTH - 1
# leapfrogs (cut to keep the phase short)
PROC_WORKERS, PROC_DEADLINE = 2, 300
PROC_CHAINS, PROC_ITERS, PROC_DEPTH, PROC_SEED = 2, 10, 5, 4


def proc_mcmc(mogp_tpu_torch, mgp, mesh):
    """Phase 11's ``sample_MOGP_MCMC`` of ``mgp`` over ``mesh``: the
    samples ``(outputs, chains, PROC_ITERS, P)``."""
    import numpy as np

    res = mogp_tpu_torch.sample_MOGP_MCMC(mgp, n_samples=PROC_ITERS, n_warmup=PROC_ITERS,
                                          n_chains=PROC_CHAINS, seed=PROC_SEED,
                                          max_depth=PROC_DEPTH, mesh=mesh)
    return np.stack([r.samples for r in res])


def _proc_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fit_workers")


def fit_worker(rank, port, n_procs):
    """One process of a fit across processes (``python3 chip_smoke.py
    --fit-worker RANK PORT N``): joins the others on localhost, runs phase
    4's warm-up fit and its timed fit over ``auto_mesh()``, and writes its
    thetas, its K2 launches, its fit wall and its gathers to
    ``build/fit_workers``; process 1 also predicts phase 3's first N_CHECK
    queries."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mogp_tpu_torch
    from mogp_tpu_torch.models import fitting
    from mogp_tpu_torch.ops import cholesky_batched as kb
    from mogp_tpu_torch.parallel import auto_mesh, init_distributed
    from mogp_tpu_torch.parallel import mesh as pmesh

    init_distributed("localhost:{}".format(port), n_procs, rank)
    mesh = auto_mesh()
    if (mesh.processes != list(range(n_procs))
            or mesh.devices[rank] != torch.device("cuda", torch.cuda.current_device())):
        raise AssertionError("process {}'s global mesh of {} processes is {}".format(
            rank, n_procs, mesh))
    x, y = make_data(N_OUTPUTS)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cuda")
    np.random.seed(0)
    t0 = time.perf_counter()
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, maxiter=MAXITER, mesh=mesh)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    kb.launches = 0
    np.random.seed(1)
    t0 = time.perf_counter()
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=N_TRIES, refit=True, maxiter=MAXITER, mesh=mesh)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    report = {"rank": rank, "device": str(mesh.devices[rank]), "warm_s": warm_s,
              "fit_s": fit_s, "k2_launches": kb.launches, "n_fit": len(mgp.get_indices_fit()),
              "gathers": list(pmesh.last_gathers), "phases": list(fitting.last_phase_times)}
    out = {"thetas": np.stack([em.theta.get_data() for em in mgp.emulators])}
    if rank == 1:
        q = np.random.RandomState(1).uniform(size=(N_CHECK, N_DIM))  # phase 3's first rows
        res = mgp.predict(q)
        out.update(mean=res.mean, unc=res.unc)
    kb.launches = 0
    del pmesh.last_gathers[:]
    t0 = time.perf_counter()
    out["mcmc"] = proc_mcmc(mogp_tpu_torch, mgp, mesh)
    torch.cuda.synchronize()
    report.update(mcmc_s=time.perf_counter() - t0, mcmc_k2_launches=kb.launches,
                  mcmc_gathers=list(pmesh.last_gathers))
    np.savez(os.path.join(_proc_dir(), "proc{}.npz".format(rank)), **out)
    with open(os.path.join(_proc_dir(), "proc{}.json".format(rank)), "w") as f:
        json.dump(report, f)
    return 0


def run_fit_workers(n_procs, deadline):
    """Phase 4's fit in ``n_procs`` processes of :func:`fit_worker`; each
    worker that fails or outlasts ``deadline`` fails the run (all killed).
    Returns ``(wall seconds, reports, results)``, one of each a process."""
    import numpy as np
    from mogp_tpu_torch.tools.workers import run_workers

    os.makedirs(_proc_dir(), exist_ok=True)
    for name in os.listdir(_proc_dir()):
        os.remove(os.path.join(_proc_dir(), name))
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    run_workers(lambda port: [[sys.executable, here, "--fit-worker", str(rank), str(port),
                               str(n_procs)] for rank in range(n_procs)], deadline,
                cwd=os.path.dirname(here))
    wall = time.perf_counter() - t0
    reports, results = [], []
    for rank in range(n_procs):
        with open(os.path.join(_proc_dir(), "proc{}.json".format(rank))) as f:
            reports.append(json.load(f))
        results.append(dict(np.load(os.path.join(_proc_dir(), "proc{}.npz".format(rank)))))
    return wall, reports, results


def fit_worker_line(rep, res, n_procs, ref_thetas, label):
    """A process's line of a fit across processes, and whether it holds
    all N_OUTPUTS outputs bit-identical to ``ref_thetas`` after launching
    K2."""
    import numpy as np

    same = sum(np.array_equal(t, r) for t, r in zip(res["thetas"], ref_thetas))
    good = same == N_OUTPUTS and rep["n_fit"] == N_OUTPUTS and rep["k2_launches"] > 0
    phases = {}
    for k, v in rep["phases"]:
        phases[k] = phases.get(k, 0.0) + v
    line = ("process {} of {} on {} ({}): warm-up fit {} s; timed fit_GP_MAP({} outputs x {} "
            "restarts, maxiter={}, mesh=auto_mesh()) {} s; phases {}; gathers (s, bytes sent) "
            "{}; outputs held {}; theta bit-identical to the one-process fit for {} of {}; "
            "cholesky_batched launches {}: {}".format(
                rep["rank"], n_procs, rep["device"], label, rep["warm_s"], N_OUTPUTS, N_TRIES,
                MAXITER, rep["fit_s"], phases, rep["gathers"], rep["n_fit"], same, N_OUTPUTS,
                rep["k2_launches"], "ok" if good else "FAIL"))
    return line, good


def phase_processes(mogp_tpu_torch, mgp, label, keep):
    """Phase 11: phase 4's fit in two processes on the card, then
    ``sample_MOGP_MCMC`` across them (module doc); returns K2's launches in
    each process's timed fit and in its MCMC."""
    import numpy as np
    import torch
    from mogp_tpu_torch.parallel import DeviceMesh

    q = np.random.RandomState(1).uniform(size=(N_CHECK, N_DIM))
    ref = mgp.predict(q)
    t0 = time.perf_counter()
    ref_mcmc = proc_mcmc(mogp_tpu_torch, mgp,
                         DeviceMesh([torch.device("cuda", 0)] * PROC_WORKERS))
    mcmc_s = time.perf_counter() - t0
    torch.cuda.empty_cache()  # the workers share the card with this process
    wall, reports, results = run_fit_workers(PROC_WORKERS, PROC_DEADLINE)
    ok = True
    for rep, res in zip(reports, results):
        line, good = fit_worker_line(rep, res, PROC_WORKERS, keep["fit_thetas"], label)
        ok = ok and good and rep["device"] == "cuda:0"
        print("phase 11: " + line)
    got = results[1]
    same_pred = (np.array_equal(got["mean"], ref.mean) and np.array_equal(got["unc"], ref.unc))
    ok = ok and same_pred
    for rep, res in zip(reports, results):
        same = int(sum(np.array_equal(a, b) for a, b in zip(res["mcmc"], ref_mcmc)))
        good = (same == N_OUTPUTS and rep["mcmc_k2_launches"] > 0
                and bool(np.isfinite(res["mcmc"]).all()))
        ok = ok and good
        print("phase 11: process {}: sample_MOGP_MCMC({} outputs x {} chains, {} + {}, "
              "max_depth {}, mesh=auto_mesh()) {} s (in one process over DeviceMesh([cuda:0] * "
              "{}): {} s); outputs whose chains are bit-identical to the one-process run's: "
              "{} of {}; gathers (s, bytes sent) {}; cholesky_batched launches {}: {}".format(
                  rep["rank"], N_OUTPUTS, PROC_CHAINS, PROC_ITERS, PROC_ITERS, PROC_DEPTH,
                  rep["mcmc_s"], PROC_WORKERS, mcmc_s, same, N_OUTPUTS, rep["mcmc_gathers"],
                  rep["mcmc_k2_launches"], "ok" if good else "FAIL"))
    print("phase 11: process 1's predict of phase 3's first {} queries against phase 4's "
          "emulator on the card: bit-identical {} (max |d mean| {}, max |d var| {}); the "
          "phase {} s: {}".format(
              N_CHECK, same_pred, float(np.max(np.abs(got["mean"] - ref.mean))),
              float(np.max(np.abs(got["unc"] - ref.unc))), wall, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("11: the fit or the chains across processes differ from one "
                             "process's, or a process did not launch K2")
    return ([rep["k2_launches"] for rep in reports],
            [rep["mcmc_k2_launches"] for rep in reports])


def main():
    import torch

    if len(sys.argv) == 5 and sys.argv[1] == "--fit-worker":
        return fit_worker(*(int(a) for a in sys.argv[2:]))
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mogp_tpu_torch
    from mogp_tpu_torch.models.gp import _predict_tile_size
    from mogp_tpu_torch.ops import _build
    from mogp_tpu_torch.ops import cholesky_batched as kb
    from mogp_tpu_torch.ops import cholesky_blocked as kbl
    from mogp_tpu_torch.ops import kernel_matrix as km
    from mogp_tpu_torch.ops import predict_fused as pf
    from mogp_tpu_torch.tools.large_n import N_DIM as LARGE_N_DIM

    if os.path.dirname(os.path.dirname(os.path.abspath(mogp_tpu_torch.__file__))) != here:
        raise RuntimeError("mogp_tpu_torch was not imported from this checkout")

    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [line.split(":", 1)[1].strip() for line in _build.build_log.splitlines()
            if "registers" in line]
    print("phase 1: {} ({}); kernel library ready in {} s (nvcc {} s); ptxas: {}".format(
        torch.cuda.get_device_name(0), smi, build_s, _build.build_seconds, regs))

    # the query tiles the main paths give the kernels (0: one untiled
    # call): the fused kernel's in phase 3, K1's in phase 5
    if pf.route("cuda", N_POINTS, 0, "stationary", False, torch.float32) != "fused":
        raise AssertionError("the headline emulator is not on the fused route")
    tile = _predict_tile_size(N_QUERIES, None, n_train=N_POINTS, n_lanes=N_OUTPUTS, fused=True,
                              n_dim=N_DIM) or N_QUERIES
    fused_shape = (N_OUTPUTS, N_POINTS, tile, N_DIM)
    tile = _predict_tile_size(LARGE_N_QUERIES, None, n_train=LARGE_N) or LARGE_N_QUERIES
    k1_shape = (1, LARGE_N, tile, LARGE_N_DIM)
    keep = {}  # what phases 4-8 hand on to phase 10
    record = phase_kernels(km, k1_shape)
    fused_record = phase_fused(pf, km, fused_shape)
    chol_record = phase_cholesky(kb)
    blocked_records = phase_blocked(kbl)
    fused_record["launches"] = phase_slice(mogp_tpu_torch, km, kb, pf, smi)
    chol_record["launches"], mgp = phase_fit(mogp_tpu_torch, km, kb, smi, keep)
    route, blocked_launches, record["launches"] = phase_large_n(
        mogp_tpu_torch, km, kb, kbl, pf, smi)
    for rec, v in zip(blocked_records, kbl.VARIANTS):
        rec["launches"] = blocked_launches[v]
        rec["routed"] = v == route
    phase_uq(mogp_tpu_torch, km, kb, pf, smi, keep)
    chol_record["launches_per_leapfrog"], fused_record["launches_per_smc_stage"] = \
        phase_inference(mogp_tpu_torch, km, kb, pf, mgp, smi, keep)
    mice = phase_mice(mogp_tpu_torch, km, kb, kbl, pf, smi, keep)["launches_per_step"]
    for rec in (record, fused_record, chol_record, *blocked_records):
        rec["launches_per_mice_step"] = mice[rec["name"]]

    # phases 9 and 10; phase 9's float64 CPU references run meanwhile in
    # worker processes, and its checks against them come last
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=3,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = cpu_references(pool)
        dimred, checks = phase_dimred(mogp_tpu_torch, km, kb, kbl, pf, smi)
        mesh = phase_mesh(mogp_tpu_torch, km, kb, kbl, pf, smi, keep)
        t1 = time.perf_counter()
        for part in ("9a", "9b", "9c"):
            checks[part](refs[part].result())
    print("phases 9 and 10: {} s, {} s of it waiting for the CPU references".format(
        time.perf_counter() - t0, time.perf_counter() - t1))
    for rec in (record, fused_record, chol_record, *blocked_records):
        name = rec["name"]
        rec["launches_per_gkdr"] = dimred["per_gkdr"][name]
        rec["launches_in_gkdr_fit"] = dimred["fit"][name]
        rec["launches_in_kdr_bench"] = dimred["9b"][name]
        rec["launches_under_mesh"] = {path: counts[name] for path, counts in mesh.items()}
    chol_record["launches_per_process_fit"], chol_record["launches_per_process_mcmc"] = \
        phase_processes(mogp_tpu_torch, mgp, smi, keep)

    print(json.dumps({"kernels": [record, fused_record, chol_record, *blocked_records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
