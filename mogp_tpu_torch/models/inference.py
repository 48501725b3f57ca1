"""Bayesian inference over GP hyperparameters: NUTS, VI, diagnostics.

Port of ``mogp_tpu/models/inference.py``.  It samples the posterior of the
MAP fit's objective, ``gp_nlp`` on the one fixed jitter rung
(``fitting._LADDER_MODES["single"]``: under ``nugget="adaptive"`` a
data-dependent ladder would make the density discontinuous in raw space):

* ``sample_GP_MCMC`` / ``sample_MOGP_MCMC`` -- NUTS (``ops/hmc.py``) with
  the chains, and for a ``MultiOutputGP`` the outputs x chains of one
  signature group, as the lanes of one batch: every leapfrog is one
  batched ``gp_nlp`` and one backward over all lanes (K2 factors them on
  the card);
* ``fit_GP_VI`` -- mean-field ADVI with ``torch.optim.Adam``;
* ``predict_MCMC`` -- posterior-predictive moments: one ``gp_fit`` over
  all thinned samples as lanes, then ``_gp_predict_impl`` (the fused
  prediction kernel on the card), then the mixture moments.

Every entry point runs where its emulator lives (the card unless the
emulator was built with ``device="cpu"``).  Samples, step sizes and the
variational parameters are float64; the potential is evaluated in the
emulator's type.

``mesh=`` (a ``parallel.DeviceMesh``) splits the chains of
``sample_GP_MCMC``, and the outputs of each ``sample_MOGP_MCMC`` group that
the mesh divides, over its devices.  A chain's start is drawn before the
split and its Philox stream is keyed by its global (output, chain) index,
so it draws the same numbers wherever it runs.
"""

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cholesky_batched as kb
from ..ops import hmc
from ..parallel.mesh import check_mesh, map_shards, split_rows, to_device
from ..utils import checkpoint as _ckpt
from .fitting import _LADDER_MODES
from .gp import GaussianProcess, _query_tile, cat_lanes, gp_fit, gp_nlp, gp_predict, \
    gp_predict_tiled, take_lanes

__all__ = [
    "sample_GP_MCMC",
    "sample_MOGP_MCMC",
    "fit_GP_VI",
    "predict_MCMC",
    "potential_scale_reduction",
    "effective_sample_size",
    "MCMCResult",
    "VIResult",
]

# the potential's jitter ladder: the one fixed rung, as mogp_tpu's
# _OPT_LADDER by default
_POTENTIAL_LADDER = _LADDER_MODES["single"]


class MCMCResult(NamedTuple):
    samples: np.ndarray        # (n_chains, n_samples, P) raw parameters
    accept_prob: np.ndarray    # (n_chains, n_samples)
    diverging: np.ndarray      # (n_chains, n_samples)
    rhat: np.ndarray           # (P,)
    ess: np.ndarray            # (P,)


class VIResult(NamedTuple):
    mean: np.ndarray           # (P,) variational mean (raw space)
    log_std: np.ndarray        # (P,)
    elbo_trace: np.ndarray     # (n_steps,)


# ---------------------------------------------------------------------------
# Convergence diagnostics (cross-chain, where the samples are)
# ---------------------------------------------------------------------------

def _as_f64(samples):
    if isinstance(samples, torch.Tensor):
        return samples.to(torch.float64)
    return torch.as_tensor(np.asarray(samples), dtype=torch.float64)


def potential_scale_reduction(samples):
    """Split R-hat (Gelman-Rubin) per parameter.

    :param samples: ``(n_chains, n_samples, P)`` tensor or array.
    :returns: ``(P,)`` float64 tensor on the samples' device.
    """
    s = _as_f64(samples)
    half = s.shape[1] // 2
    split = torch.cat([s[:, :half], s[:, half:2 * half]], dim=0)   # (2C, half, P)
    W = torch.mean(torch.var(split, dim=1, correction=1), dim=0)
    B = half * torch.var(torch.mean(split, dim=1), dim=0, correction=1)
    var_plus = (half - 1) / half * W + B / half
    return torch.sqrt(var_plus / W)


def effective_sample_size(samples):
    """Bulk effective sample size per parameter: FFT autocorrelation with
    Geyer's initial-positive-sequence truncation.

    :param samples: ``(n_chains, n_samples, P)`` tensor or array.
    :returns: ``(P,)`` float64 tensor on the samples' device.
    """
    s = _as_f64(samples)
    C, N, P = s.shape
    x = s - torch.mean(s, dim=1, keepdim=True)
    f = torch.fft.rfft(x, n=2 * N, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * N, dim=1)[:, :N] / N

    mean_var = torch.mean(acov[:, 0], dim=0) * N / (N - 1.0)
    var_plus = mean_var * (N - 1.0) / N + torch.var(
        torch.mean(s, dim=1), dim=0, correction=1 if C > 1 else 0)
    rho = 1.0 - (mean_var - torch.mean(acov, dim=0)) / var_plus   # (N, P)

    # Geyer: sum consecutive pairs while positive
    even = rho[0::2]
    odd = torch.zeros_like(even)
    odd[:rho[1::2].shape[0]] = rho[1::2]
    pair = torch.cummin(even + odd, dim=0).values   # monotone sequence
    negative = pair <= 0.0
    cutoff = torch.where(negative.any(dim=0), torch.argmax(negative.to(torch.int8), dim=0),
                         pair.shape[0])
    idx = torch.arange(pair.shape[0], device=s.device)[:, None]
    tau = -1.0 + 2.0 * torch.sum(torch.where(idx < cutoff, pair, 0.0), dim=0)
    tau = torch.clamp_min(tau, 1.0 / np.log10(float(N)))
    return C * N / tau


# ---------------------------------------------------------------------------
# NUTS over GP hyperparameters
# ---------------------------------------------------------------------------

# Segment budget in chain-iterations (lanes x transitions) of mogp_tpu,
# where one XLA dispatch running for minutes tripped the TPU runtime's
# watchdog.  The port runs transition by transition and has no watchdog to
# respect: the segments only decide where checkpoints fall.  The policy is
# kept as it is.
_NUTS_SEG_BUDGET = 3200


def _auto_segment(n_lanes, n_iters):
    """Segment length of ``mogp_tpu``'s policy, or None for one segment.
    Here it places the checkpoints of a run with ``checkpoint_path``."""
    total = n_lanes * n_iters
    if total <= _NUTS_SEG_BUDGET:
        return None
    n_parts = min(-(-total // _NUTS_SEG_BUDGET), n_iters)
    return -(-n_iters // n_parts)


def _eager_potential(data, kernel, nugget_type):
    dtype = data.inputs.dtype

    def pg(q):
        with torch.enable_grad():
            raw = q.detach().to(dtype).requires_grad_(True)
            u = gp_nlp(raw, data, kernel, nugget_type, sparse_ladder=_POTENTIAL_LADDER)
            (g,) = torch.autograd.grad(u.sum(), raw)
        return u.detach().to(torch.float64), g.to(torch.float64)

    return pg


# one CUDA graph capture at a time in the process: the shards of a mesh of
# several cards capture from threads of their own, and a capture's set-up
# (a synchronize, the allocator's cache emptied, the device's random-number
# generator registered with the graph) must not meet another capture
_capture_lock = threading.Lock()


class _GraphedPotential:
    """The potential on the card, captured once into a CUDA graph and
    replayed for every evaluation.

    One eager value and gradient at n = 210 is ~400 kernel launches, which
    the host enqueues slower than the card runs them (5.0 ms a call at 64
    lanes, 13% of it device time; ``tools/prof_inference.py``).  A replay
    runs the same kernels from one host call; K2's wrapper counts its
    launches there (``ops/cholesky_batched.py::replay``).  The lanes' shape is fixed at the first call.
    """

    def __init__(self, eager):
        self._eager = eager
        self._graph = None

    def __call__(self, q):
        if self._graph is None:
            self._capture(q)
        elif q.shape != self._q.shape:
            raise ValueError("a captured potential takes {} positions, got {}".format(
                tuple(self._q.shape), tuple(q.shape)))
        self._q.copy_(q)
        kb.replay(self._graph, self._k2)
        return self._u.clone(), self._g.clone()

    def _capture(self, q):
        with _capture_lock:
            self._capture_locked(q)

    def _capture_locked(self, q):
        self._q = q.detach().clone()
        side = torch.cuda.Stream(device=q.device)
        side.wait_stream(torch.cuda.current_stream(q.device))
        with torch.cuda.stream(side):
            for _ in range(2):   # warm-up outside capture (library handles, workspaces)
                self._eager(self._q)
        torch.cuda.current_stream(q.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        before = kb.recorded_here()
        # on a stream of q's device: torch.cuda.graph's default capture
        # stream is one for the process, made on the device of its first
        # use; thread_local: the other shards' threads allocate meanwhile
        with torch.cuda.graph(self._graph, stream=side, capture_error_mode="thread_local"):
            self._u, self._g = self._eager(self._q)
        self._k2 = kb.recorded_here() - before


def gp_potential(data, kernel, nugget_type):
    """``pg_fn`` of ``ops/hmc.py`` for ``data``'s lanes: float64 positions
    ``(L, P)`` -> the negative log posterior ``(L,)`` and its gradient,
    evaluated in the data's type by one batched ``gp_nlp`` and one
    backward; on the card through a CUDA graph (:class:`_GraphedPotential`),
    which runs the same kernels."""
    pg = _eager_potential(data, kernel, nugget_type)
    return _GraphedPotential(pg) if data.inputs.device.type == "cuda" else pg


def _chain_starts(device, seed, outputs, n_chains, centers=None, priors=None):
    """``(len(outputs) * n_chains, P)`` float64 starts, output-major: each
    ``center + 0.5 N(0, 1)``, or a prior draw, from a generator of its own
    seeded by ``(seed, output, chain)``."""
    rows = []
    for j, out in enumerate(outputs):
        for c in range(n_chains):
            g = hmc.seeded_generator(device, seed, out, c)
            if centers is None:
                rows.append(priors.sample_raw(g))
            else:
                center = torch.as_tensor(centers[j], dtype=torch.float64, device=device)
                rows.append(center + 0.5 * torch.randn(center.shape, generator=g,
                                                       dtype=torch.float64, device=device))
    return torch.stack(rows)


def _nuts_sample_seg(pg, carry, stream, t0, n_seg, max_depth):
    """One sampling segment (the function a preemption test interrupts)."""
    return hmc.nuts_sample_segment(pg, carry, stream, t0, n_seg, max_depth)


def _warm_template(q0):
    """A warmup carry of ``q0``'s shape: the structure a checkpoint's leaves
    are put back into."""
    return hmc.NUTSWarmupCarry(q0, q0[:, 0], q0, hmc._da_init(q0[:, 0]), q0,
                               hmc._welford_init(q0))


def _unflatten(template, leaves):
    if isinstance(template, tuple):
        return type(template)(*[_unflatten(t, leaves) for t in template])
    return next(leaves)


def _ckpt_save(path, tag, phase, idx, next_transition, carry, samples=None, infos=None):
    """Persist a run's state after a segment: the phase and its index, the
    random stream's state (the next transition index), the carry's leaves
    and the samples so far."""
    payload = {"tag": np.asarray(tag), "phase": np.asarray(phase), "idx": np.asarray(idx),
               "next_transition": np.asarray(next_transition)}
    for i, leaf in enumerate(_ckpt._leaves(carry)):
        payload["leaf_{}".format(i)] = leaf.cpu().numpy()
    if samples is not None:
        payload["samples"] = samples
        for i, leaf in enumerate(infos):
            payload["info_{}".format(i)] = leaf
    _ckpt.atomic_savez(path, **payload)


def _run_tag(q0, seed, n_warmup, n_samples, max_depth, target_accept, data, kernel,
             nugget_type):
    """Checkpoint identity of a chain run: the starts, the seed, the
    sampler settings and the posterior itself (every ``GPData`` leaf and
    the kernel / nugget), so a changed run starts fresh."""
    return _ckpt.config_tag(
        settings=(int(n_warmup), int(n_samples), int(max_depth), float(target_accept),
                  int(seed)),
        arrays=(q0,), pytrees=(data,), strings=[type(kernel).__name__, nugget_type],
    )


def _run_nuts_chains(data, q0, chains, outputs, seed, kernel, nugget_type, n_warmup,
                     n_samples, max_depth, target_accept, segment=None, checkpoint_path=None):
    """Run the lanes of ``q0`` ``(L, P)`` (float64, on ``data``'s device) as
    NUTS chains on ``data``'s posteriors (``mogp_tpu/models/inference.py:
    299-425``).

    With ``checkpoint_path``, the chains' state (warmup adaptation, the
    stream's next transition, the samples so far) is saved after every
    segment and a run started again with the same arguments resumes from
    the last one.  The file is tagged with the run (:func:`_run_tag`), so a
    changed configuration starts fresh, and removed on completion.

    :returns: ``(samples (L, n_samples, P), [accept_prob, step_size,
        n_leapfrog, diverging, energy] of (L, n_samples))``, numpy.
    """
    L = q0.shape[0]
    seg_w = segment or _auto_segment(L, n_warmup)
    seg_s = segment or _auto_segment(L, n_samples)
    if checkpoint_path is not None:
        seg_w = seg_w or max(1, n_warmup // 4)
        seg_s = seg_s or max(1, n_samples // 4)
    seg_w = seg_w or max(1, n_warmup)
    seg_s = seg_s or max(1, n_samples)

    pg = gp_potential(data, kernel, nugget_type)
    stream = hmc.Stream(seed, chains, outputs)
    tag = None
    ckpt = None
    if checkpoint_path is not None:
        tag = _run_tag(q0, seed, n_warmup, n_samples, max_depth, target_accept, data, kernel,
                       nugget_type)
        ckpt = _ckpt.load_tagged(checkpoint_path, tag, "NUTS")

    i0, done = 0, 0
    sample_parts, info_parts = [], []
    carry = scarry = None
    if ckpt is not None:
        leaves = iter(torch.as_tensor(ckpt["leaf_{}".format(i)], device=q0.device)
                      for i in range(sum(k.startswith("leaf_") for k in ckpt.files)))
        if int(ckpt["phase"]) == 0:
            carry = _unflatten(_warm_template(q0), leaves)
            i0 = int(ckpt["idx"])
        else:
            scarry = _unflatten(hmc.nuts_warmup_finish(_warm_template(q0)), leaves)
            i0, done = n_warmup, int(ckpt["idx"])
            sample_parts = [ckpt["samples"]]
            info_parts = [[ckpt["info_{}".format(i)] for i in range(len(hmc.NUTSInfo._fields))]]
    if carry is None and scarry is None:
        carry = hmc.nuts_warmup_init(pg, q0)

    m1, m2 = int(n_warmup * 0.5), int(n_warmup * 0.9)
    while i0 < n_warmup:
        n_seg = min(seg_w, n_warmup - i0)
        carry = hmc.nuts_warmup_segment(pg, carry, stream, i0, n_seg, m1, m2, max_depth,
                                        target_accept)
        i0 += n_seg
        if checkpoint_path is not None:
            _ckpt_save(checkpoint_path, tag, 0, i0, i0, carry)
    if scarry is None:
        scarry = hmc.nuts_warmup_finish(carry)

    while done < n_samples:
        n_seg = min(seg_s, n_samples - done)
        scarry, s, info = _nuts_sample_seg(pg, scarry, stream, n_warmup + done, n_seg, max_depth)
        # one host transfer per segment bounds the samples kept on the device
        sample_parts.append(s.cpu().numpy())
        info_parts.append([x.cpu().numpy() for x in info])
        done += n_seg
        if checkpoint_path is not None:
            _ckpt_save(checkpoint_path, tag, 1, done, n_warmup + done, scarry,
                       np.concatenate(sample_parts, axis=1),
                       [np.concatenate(x, axis=1) for x in zip(*info_parts)])
    if checkpoint_path is not None:
        _ckpt.remove_checkpoint(checkpoint_path)
    samples = np.concatenate(sample_parts, axis=1) if sample_parts else np.zeros((L, 0, q0.shape[1]))
    infos = [np.concatenate(x, axis=1) for x in zip(*info_parts)]
    return samples, infos


def _run_sharded(mesh, data, q0, chains, outputs, seed, kernel, nugget_type, n_warmup,
                 n_samples, max_depth, target_accept, segment, checkpoint_path, parts):
    """:func:`_run_nuts_chains` over the lane ranges ``parts`` (slices of
    ``q0``'s rows), one per shard of ``mesh`` on its device; shard ``k``
    checkpoints to ``"{checkpoint_path}.shard{k}"``.  The results are
    concatenated in lane order."""
    def shard(k, device):
        lanes = parts[k]
        ckpt = None if checkpoint_path is None else "{}.shard{}".format(checkpoint_path, k)
        return _run_nuts_chains(
            to_device(take_lanes(data, lanes), device), q0[lanes].to(device),
            chains[lanes].to(device), outputs[lanes].to(device), seed, kernel, nugget_type,
            n_warmup, n_samples, max_depth, target_accept, segment=segment,
            checkpoint_path=ckpt,
        )

    results = map_shards(mesh, shard, n_items=len(parts))
    samples = np.concatenate([r[0] for r in results], axis=0)
    infos = [np.concatenate(x, axis=0) for x in zip(*[r[1] for r in results])]
    return samples, infos


def _result(samples, infos):
    s = torch.as_tensor(samples)
    return MCMCResult(
        samples=samples,
        accept_prob=infos[0],
        diverging=infos[3],
        rhat=potential_scale_reduction(s).numpy(),
        ess=effective_sample_size(s).numpy(),
    )


def sample_GP_MCMC(
    gp: GaussianProcess,
    n_samples=500,
    n_warmup=500,
    n_chains=4,
    seed=0,
    max_depth=8,
    target_accept=0.8,
    theta0=None,
    mesh=None,
    segment=None,
    checkpoint_path=None,
):
    """Sample the GP hyperparameter posterior with NUTS, ``n_chains``
    chains as the lanes of one batch on the emulator's device.

    Chains start at ``theta0 + 0.5 N(0, 1)`` (identical starts would make
    R-hat meaningless), or from the priors (``GPPriors.sample_raw``) when
    ``theta0`` is ``None``; chain ``c``'s start and stream depend only on
    ``(seed, c)``.  ``segment`` sets the segment length of both phases;
    with ``checkpoint_path`` the chains' state is saved after every
    segment, a run started again resumes from the last one (an
    extension-less path included), and the file is removed on completion.
    ``mesh`` splits the chains over its devices in consecutive shares
    (shard ``k`` checkpoints to ``"{checkpoint_path}.shard{k}"``).

    :returns: ``MCMCResult`` with raw-space samples and diagnostics.
    """
    check_mesh(mesh)
    device = gp._device
    centers = None if theta0 is None else [np.asarray(theta0, dtype=np.float64)]
    q0 = _chain_starts(device, seed, [0], n_chains, centers=centers, priors=gp.priors)
    data = take_lanes(gp._data, torch.zeros(n_chains, dtype=torch.int64, device=device))
    args = (data, q0, torch.arange(n_chains, device=device),
            torch.zeros(n_chains, dtype=torch.int64, device=device), seed, gp.kernel,
            gp.nugget_type, n_warmup, n_samples, max_depth, target_accept)
    if mesh is None:
        samples, infos = _run_nuts_chains(*args, segment=segment,
                                          checkpoint_path=checkpoint_path)
    else:
        samples, infos = _run_sharded(
            mesh, *args, segment, checkpoint_path,
            split_rows(n_chains, mesh.shape[mesh.axis_names[0]]))
    return _result(samples, infos)


def sample_MOGP_MCMC(
    mgp,
    n_samples=500,
    n_warmup=500,
    n_chains=4,
    seed=0,
    max_depth=8,
    target_accept=0.8,
    mesh=None,
    segment=None,
    checkpoint_path=None,
):
    """NUTS posteriors for every output of a fitted ``MultiOutputGP``: the
    outputs x chains of each signature group are the lanes of one batch
    (the reference's target "full MultiOutputGP fit + NUTS hyperparameter
    posteriors for a tsunami-scale emulator").  Chains start at each
    output's MAP fit + 0.5 N(0, 1); chain ``c`` of output ``i`` depends
    only on ``(seed, i, c)``.  With ``checkpoint_path``, group ``g``
    checkpoints to ``"{checkpoint_path}.group{g}"``.  ``mesh`` splits the
    outputs of each group whose size its first axis divides over its
    devices, whole outputs (with their chains) per shard, each shard
    checkpointing to ``".shard{k}"`` after the group's path; another group
    runs whole on the emulators' device.  A mesh that spans processes
    (``parallel.init_distributed``) splits the same way: each process runs
    its own shards, and every process receives every output's result, as
    ``mogp_tpu``'s processes do.

    :returns: list of per-output ``MCMCResult``.
    """
    from .mogp import MultiOutputGP

    check_mesh(mesh, across_processes=True)
    assert isinstance(mgp, MultiOutputGP)
    assert mgp.get_indices_not_fit() == [], (
        "MAP-fit all outputs first (fit_GP_MAP) to initialize chains"
    )
    results = [None] * mgp.n_emulators
    groups = sorted(mgp._groups().items(), key=lambda kv: kv[1][0])
    for g_idx, (_, rel) in enumerate(groups):
        ems = [mgp.emulators[i] for i in rel]
        em0 = ems[0]
        device = em0._device
        G = len(ems)
        lane_output = torch.arange(G, device=device).repeat_interleave(n_chains)
        data = take_lanes(cat_lanes([em._data for em in ems]), lane_output)
        q0 = _chain_starts(device, seed, rel, n_chains,
                           centers=[em.theta.get_data() for em in ems])
        ckpt_g = None if checkpoint_path is None else "{}.group{}".format(checkpoint_path, g_idx)
        args = (data, q0, torch.arange(n_chains, device=device).repeat(G),
                torch.as_tensor(rel, device=device).repeat_interleave(n_chains), seed, em0.kernel,
                em0.nugget_type, n_warmup, n_samples, max_depth, target_accept)
        n_dev = 1 if mesh is None else mesh.shape[mesh.axis_names[0]]
        if mesh is None or G % n_dev:
            samples, infos = _run_nuts_chains(*args, segment=segment, checkpoint_path=ckpt_g)
        else:
            per = G // n_dev * n_chains
            samples, infos = _run_sharded(mesh, *args, segment, ckpt_g,
                                          [slice(k * per, (k + 1) * per) for k in range(n_dev)])
        samples = samples.reshape((G, n_chains) + samples.shape[1:])
        infos = [x.reshape((G, n_chains) + x.shape[1:]) for x in infos]
        for j, i in enumerate(rel):
            results[i] = _result(samples[j], [x[j] for x in infos])
    return results


# ---------------------------------------------------------------------------
# Mean-field VI (ADVI)
# ---------------------------------------------------------------------------

_LOG_2PI = float(np.log(2.0 * np.pi))


def _neg_elbo(mu, log_std, eps, potential):
    """The reparameterized negative ELBO ``mean_k nlp(mu + std eps_k) -
    H(q)`` at the draws ``eps`` ``(n_mc, P)`` and its gradient in
    ``(mu, log_std)``, all float64; ``potential`` is :func:`gp_potential`
    of ``n_mc`` lanes.  A draw
    whose ``gp_nlp`` is not finite (a failed factorization) counts 1e10,
    a constant, as in ``mogp_tpu``, and adds nothing to the gradient.

    :returns: ``(loss, grad_mu, grad_log_std)``.
    """
    std = torch.exp(log_std)
    nlps, gz = potential(mu + std * eps)
    finite = torch.isfinite(nlps)
    nlps = torch.where(finite, nlps, 1e10)
    gz = torch.where(finite[:, None], gz, 0.0)
    P = mu.shape[0]
    entropy = torch.sum(log_std) + 0.5 * P * (1.0 + _LOG_2PI)
    loss = torch.mean(nlps) - entropy
    return loss, gz.mean(dim=0), (gz * eps).mean(dim=0) * std - 1.0


def _vi_run(mu0, log_std0, draw, n_steps, learning_rate, data, kernel, nugget_type):
    """Adam on the negative ELBO from ``(mu0, log_std0)``, with the draws
    ``draw(step) -> eps (n_mc, P)``; Adam's settings are optax's
    ``adam(learning_rate)``.  :returns: ``(mu, log_std, elbo_trace)``."""
    mu = mu0.clone().requires_grad_(True)
    log_std = log_std0.clone().requires_grad_(True)
    opt = torch.optim.Adam([mu, log_std], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    trace = torch.empty(n_steps, dtype=torch.float64, device=mu.device)
    potential = gp_potential(data, kernel, nugget_type)
    for k in range(n_steps):
        loss, g_mu, g_ls = _neg_elbo(mu.detach(), log_std.detach(), draw(k), potential)
        mu.grad, log_std.grad = g_mu, g_ls
        opt.step()
        trace[k] = -loss
    return mu.detach(), log_std.detach(), trace


def fit_GP_VI(
    gp: GaussianProcess,
    n_steps=1000,
    n_mc=8,
    learning_rate=0.05,
    seed=0,
    theta0=None,
):
    """Mean-field ADVI over the raw hyperparameters: maximize the
    reparameterized ELBO ``E_q[-nlp(raw)] + H(q)`` for a diagonal Gaussian
    ``q`` (start: mean ``theta0`` or 0, log std -2) with Adam, ``n_mc``
    draws a step from a generator seeded with ``seed`` on the emulator's
    device; every step is one batched ``gp_nlp`` of ``n_mc`` lanes and its
    backward.
    """
    device = gp._device
    P = gp.n_params
    mu0 = torch.as_tensor(np.zeros(P) if theta0 is None else np.asarray(theta0, np.float64),
                          dtype=torch.float64, device=device)
    log_std0 = torch.full((P,), -2.0, dtype=torch.float64, device=device)
    data = take_lanes(gp._data, torch.zeros(n_mc, dtype=torch.int64, device=device))
    g = hmc.seeded_generator(device, seed)

    def draw(_):
        return torch.randn((n_mc, P), generator=g, dtype=torch.float64, device=device)

    mu, log_std, trace = _vi_run(mu0, log_std0, draw, n_steps, learning_rate, data, gp.kernel,
                                 gp.nugget_type)
    return VIResult(mean=mu.cpu().numpy(), log_std=log_std.cpu().numpy(),
                    elbo_trace=trace.cpu().numpy())


# ---------------------------------------------------------------------------
# Posterior-predictive
# ---------------------------------------------------------------------------

def predict_MCMC(gp, samples, testing, thin=1, include_nugget=True):
    """Posterior-predictive mean and variance marginalized over
    hyperparameter samples (mixture moments of the per-sample predictions).

    The thinned samples are the lanes of one ``gp_fit`` (K2 on the card)
    and one prediction (the fused kernel on the card's fused route);
    samples whose prediction is not finite are dropped.  A standardized
    emulator's moments are mapped to its targets' units, as ``predict``
    maps them.

    :param samples: ``(n_chains, n_samples, P)`` or ``(n_samples, P)``
        raw-space samples (e.g. from ``sample_GP_MCMC``).
    :returns: ``(mean, variance)``, numpy float64 of length ``n_predict``.
    """
    samples = np.asarray(samples)
    if samples.ndim == 3:
        samples = samples.reshape(-1, samples.shape[-1])
    samples = samples[::thin]

    testing = gp._process_inputs(testing)
    dmtest = gp.get_design_matrix(testing)
    raws = gp._tensor(samples)
    data = take_lanes(gp._data, torch.zeros(raws.shape[0], dtype=torch.int64,
                                            device=raws.device))
    arts = gp_fit(raws, data, gp.kernel, gp.nugget_type)
    tile = _query_tile(testing.shape[0], None, data, gp.kernel, gp.nugget_type)
    args = (arts, data, gp._tensor(testing), gp._tensor(dmtest), gp.kernel, gp.nugget_type)
    if tile:
        mus, variances = gp_predict_tiled(*args, include_nugget=include_nugget, tile=tile)
    else:
        mus, variances = gp_predict(*args, include_nugget=include_nugget)
    mus = mus.to("cpu", torch.float64).numpy()
    variances = variances.to("cpu", torch.float64).numpy()
    finite = np.isfinite(mus).all(axis=1) & np.isfinite(variances).all(axis=1)
    mus, variances = mus[finite], variances[finite]
    mean = mus.mean(axis=0)
    var = variances.mean(axis=0) + mus.var(axis=0)
    return mean * gp._t_std + gp._t_mean, var * gp._t_std**2
