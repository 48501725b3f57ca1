"""Sequential Monte Carlo sampling of NROY space for history matching.

Port of ``mogp_tpu/uq/smc.py``.  A particle population on the query box
adapts onto the not-ruled-out-yet region through tightening
implausibility thresholds:

    stage k:  target = uniform on { x in bounds : I(x) <= tau_k },
    tau_k = max(quantile_q(I of the population), threshold)

with systematic resampling and random-walk Metropolis rejuvenation at each
stage, and the proposal scale adapted towards 30% acceptance.

The particles, their implausibilities and the stage arithmetic live on the
emulator's device (the card unless the emulator was built with
``device="cpu"``), in its type; the resampling's weights and cumulative
sum are float64.  Every implausibility evaluation predicts the whole
population in one call: for a ``MultiOutputGP`` through
``MultiOutputGP._predict_groups`` (the fused prediction kernel on the
card's fused route), with the observations mapped into each emulator's
units in float64, as ``HistoryMatching``'s device sweep maps them, so a
standardized emulator gives the implausibility of its unstandardized twin;
``mogp_tpu`` compares a standardized emulator's predictions with
observations in the targets' units.

Randomness: the initial population, then each stage, draws from a
``torch.Generator`` seeded by ``(seed, stage)``, so a run with
``checkpoint_path`` (saved after every stage, resumed from the last one)
equals the run without it.

With ``mesh=`` (a ``parallel.DeviceMesh``) only the prediction is split:
every implausibility evaluation cuts the population into consecutive
shares, one per device of the mesh, and gathers the shares' I back.  The
draws, weights and resampling stay on the emulator's device, so the
particles do not depend on the mesh.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models.gp import GaussianProcessBase, gp_predict
from ..models.meanfun import design_matrix_fn
from ..models.mogp import MultiOutputGPBase
from ..ops.hmc import seeded_generator
from ..parallel.mesh import check_mesh, map_shards, split_rows, to_device
from ..utils import checkpoint as _ckpt

__all__ = ["SMCResult", "smc_history_match", "systematic_resample"]

# the seed word of the initial population's generator; stage k uses k
_INIT_STREAM = 2**32 - 1


class SMCResult(NamedTuple):
    particles: np.ndarray       # (n_particles, D) final NROY-region samples
    implausibility: np.ndarray  # (n_particles,)
    thresholds: np.ndarray      # (n_stages,) adaptive threshold schedule
    accept_rates: np.ndarray    # (n_stages,) MH acceptance per stage
    nroy_fraction: float        # fraction of final particles with I <= threshold


def systematic_resample(offset, weights, n):
    """Systematic resampling: ``(n,)`` int64 indices at the stratified
    positions ``(offset + arange(n)) / n`` of the normalized cumulative
    ``weights`` (unnormalized, float64).  ``offset`` is one uniform draw;
    ``mogp_tpu`` takes a key and draws it.  An index past the end (a
    position above the rounded total) is clamped to the last particle, as
    JAX clamps its gather."""
    weights = weights / torch.sum(weights)
    positions = (offset + torch.arange(n, dtype=weights.dtype, device=weights.device)) / n
    idx = torch.searchsorted(torch.cumsum(weights, dim=0), positions)
    return torch.clamp_max(idx, weights.shape[0] - 1)


def _make_implausibility_fn(gp, obs_mean, obs_var, discrepancy, include_nugget, rank=1,
                            device=None):
    """``x (m, D) tensor -> I (m,)`` on ``device`` (default the emulator's)
    (``mogp_tpu/uq/smc.py:56-112``).

    A single ``GaussianProcess`` gives the plain implausibility; a
    ``MultiOutputGP`` (one homogeneous group) the rank-``rank`` largest
    over the outputs (0 = the maximum), by ``torch.sort`` along the outputs
    axis.  ``obs_mean`` / ``obs_var`` are float64 numpy arrays (one entry
    per output) or floats, ``discrepancy`` a float, all in the targets'
    units.
    """
    if isinstance(gp, MultiOutputGPBase):
        assert len(gp._groups()) == 1, (
            "multi-output SMC requires a homogeneous emulator configuration"
        )
        n_obs = obs_mean.shape[0]
        eff_rank = 0 if n_obs == 1 else min(rank, n_obs - 1)
        rows = list(range(gp.n_emulators))
        em0 = gp.emulators[0]
        device = em0._device if device is None else device
        scale = np.array([em._t_std for em in gp.emulators])
        shift = np.array([em._t_mean for em in gp.emulators])
        z = torch.as_tensor((obs_mean - shift) / scale, dtype=em0._dtype, device=device)[:, None]
        v = torch.as_tensor((obs_var + discrepancy) / scale**2, dtype=em0._dtype,
                            device=device)[:, None]

        def I_fn(x):
            ((_, tiles, _, _),) = gp._predict_groups(x, rows, include_nugget=include_nugget,
                                                     device=device)
            I = torch.cat([torch.abs(z - mu) / torch.sqrt(var + v) for mu, var in tiles], dim=1)
            return torch.sort(I, dim=0).values[n_obs - eff_rank - 1]

        return I_fn

    dm_fn = design_matrix_fn(gp._mean, state=gp._mean_state)
    z = (float(obs_mean) - gp._t_mean) / gp._t_std
    v = (float(obs_var) + discrepancy) / gp._t_std**2
    device = gp._device if device is None else device
    arts, data = to_device(gp._artifacts, device), to_device(gp._data, device)

    def I_fn(x):
        x = x.to(device, gp._dtype)
        mu, var = gp_predict(arts, data, x, dm_fn(x), gp.kernel, gp.nugget_type,
                             include_nugget=include_nugget)
        return torch.abs(z - mu[0]) / torch.sqrt(var[0] + v)

    return I_fn


def _sharded_implausibility_fn(mesh, make_fn):
    """``x -> I`` with the rows of ``x`` cut into consecutive shares, one
    per shard of ``mesh``, each evaluated by ``make_fn(device)``'s function
    on its device and gathered back onto ``x``'s device."""
    devices = mesh.shard_devices()
    fns = [make_fn(d) for d in devices]

    def I_fn(x):
        parts = split_rows(x.shape[0], len(devices))
        shares = map_shards(mesh, lambda k, d: fns[k](x[parts[k]]), n_items=len(parts))
        return torch.cat([s.to(x.device) for s in shares])

    return I_fn


def _stage(I_fn, particles, scale, lo, hi, threshold, quantile, n_mcmc, generator):
    """One anneal stage: the adaptive threshold, systematic resampling of
    the survivors, ``n_mcmc`` random-walk Metropolis steps within {I <=
    tau} and the scale's adaptation.

    :returns: ``(particles, I, scale, tau, acceptance rate)``, tensors.
    """
    n, D = particles.shape
    I = I_fn(particles)
    tau = torch.clamp_min(torch.quantile(I, quantile), threshold)
    w = (I <= tau).to(torch.float64) + 1e-12
    offset = torch.rand((), generator=generator, dtype=torch.float64, device=particles.device)
    idx = systematic_resample(offset, w, n)
    particles, I = particles[idx], I[idx]
    n_acc = torch.zeros((), dtype=particles.dtype, device=particles.device)
    for _ in range(n_mcmc):
        prop = particles + scale * torch.randn((n, D), generator=generator, dtype=particles.dtype,
                                               device=particles.device)
        inside = torch.all((prop >= lo) & (prop <= hi), dim=1)
        I_prop = I_fn(prop)
        ok = inside & (I_prop <= tau)
        particles = torch.where(ok[:, None], prop, particles)
        I = torch.where(ok, I_prop, I)
        n_acc = n_acc + torch.mean(ok.to(particles.dtype))
    acc_rate = n_acc / n_mcmc
    return particles, I, scale * torch.exp(acc_rate - 0.3), tau, acc_rate


def smc_history_match(
    gp,
    obs,
    bounds,
    threshold=3.0,
    n_particles=4096,
    n_stages=10,
    n_mcmc=5,
    discrepancy=0.0,
    include_nugget=True,
    quantile=0.5,
    rank=1,
    seed=0,
    mesh=None,
    checkpoint_path=None,
):
    """Sample the NROY region of a fitted emulator with adaptive-threshold
    SMC.

    :param gp: fitted ``GaussianProcess`` or ``MultiOutputGP``.
    :param obs: ``[mean, variance]`` (or a float), one entry per output for
        a ``MultiOutputGP``, in the targets' units.
    :param bounds: ``(D, 2)`` ``[lo, hi]`` per input dimension; the prior
        over query space is uniform on the box.
    :param threshold: final implausibility threshold (3, as
        ``HistoryMatching``).
    :param n_stages: anneal stages; thresholds adapt as the ``quantile`` of
        the population's I, floored at ``threshold``.
    :param n_mcmc: random-walk Metropolis steps per stage.
    :param rank: the rank-scored order over outputs (0 = max; default 1).
    :param mesh: a ``parallel.DeviceMesh`` over which each implausibility
        evaluation is split (module doc).
    :param checkpoint_path: optional ``.npz`` path (extension optional):
        the population, scale, stream state and stage are saved after
        every stage, a run started again resumes from the last one, and the
        file is removed on completion.  The checkpoint is tagged with the
        settings and the emulators' data.
    :returns: ``SMCResult``.
    """
    assert isinstance(gp, (GaussianProcessBase, MultiOutputGPBase)), (
        "smc_history_match needs a GaussianProcess or MultiOutputGP"
    )
    check_mesh(mesh)
    if isinstance(obs, (float, int)):
        obs = [float(obs), 0.0]
    if isinstance(gp, MultiOutputGPBase):
        obs_mean = np.atleast_1d(np.asarray(obs[0], dtype=np.float64))
        obs_var = np.atleast_1d(np.asarray(obs[1], dtype=np.float64))
        assert obs_mean.shape[0] == gp.n_emulators, "need one observation per emulator output"
        ref_em = gp.emulators[0]
    else:
        obs_mean, obs_var = float(obs[0]), float(obs[1])
        ref_em = gp

    bounds = np.asarray(bounds, dtype=np.float64)
    assert bounds.shape == (gp.D, 2), "bounds must have shape (D, 2)"
    device, dtype = ref_em._device, ref_em._dtype
    lo = torch.as_tensor(bounds[:, 0], dtype=dtype, device=device)
    hi = torch.as_tensor(bounds[:, 1], dtype=dtype, device=device)
    def make_fn(dev=None):
        return _make_implausibility_fn(gp, obs_mean, obs_var, float(discrepancy),
                                       include_nugget, rank=rank, device=dev)

    I_fn = make_fn() if mesh is None else _sharded_implausibility_fn(mesh, make_fn)

    g = seeded_generator(device, seed, _INIT_STREAM)
    particles = lo + (hi - lo) * torch.rand((n_particles, gp.D), generator=g, dtype=dtype,
                                            device=device)
    scale = (hi - lo) * 0.2
    k0, taus, accs = 0, [], []
    tag = None
    if checkpoint_path is not None:
        tag = _ckpt._smc_tag(gp, obs_mean, obs_var, bounds, threshold, n_particles, n_stages,
                             n_mcmc, discrepancy, include_nugget, quantile, rank, seed)
        ck = _ckpt.load_smc(checkpoint_path, tag=tag)
        if ck is not None:
            k0 = ck["stage"]
            taus = [torch.tensor(t, dtype=dtype, device=device) for t in ck["taus"]]
            accs = [torch.tensor(a, dtype=dtype, device=device) for a in ck["accs"]]
            particles = torch.as_tensor(ck["particles"], dtype=dtype, device=device)
            scale = torch.as_tensor(ck["scale"], dtype=dtype, device=device)

    for k in range(k0, n_stages):
        particles, _, scale, tau, acc = _stage(I_fn, particles, scale, lo, hi, threshold,
                                               quantile, n_mcmc, seeded_generator(device, seed, k))
        taus.append(tau)
        accs.append(acc)
        if checkpoint_path is not None:
            _ckpt.save_smc(checkpoint_path, {
                "particles": particles.cpu().numpy(),
                "scale": scale.cpu().numpy(),
                "key": np.array([seed, k + 1]),
                "stage": k + 1,
                "taus": torch.stack(taus).cpu().numpy(),
                "accs": torch.stack(accs).cpu().numpy(),
            }, tag=tag)
    I = I_fn(particles)
    if checkpoint_path is not None:
        _ckpt.remove_checkpoint(checkpoint_path)

    I = I.to("cpu", torch.float64).numpy()
    stack = (lambda xs: torch.stack(xs).to("cpu", torch.float64).numpy()) if taus else (
        lambda xs: np.zeros(0))
    return SMCResult(
        particles=particles.to("cpu", torch.float64).numpy(),
        implausibility=I,
        thresholds=stack(taus),
        accept_rates=stack(accs),
        nroy_fraction=float(np.mean(I <= threshold)),
    )
