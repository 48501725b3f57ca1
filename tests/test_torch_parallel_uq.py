"""The ``mesh=`` argument of the port's UQ and inference entry points, on
``device="cpu"`` meshes of 4 and 8.

Port of ``tests/test_parallel.py`` (the UQ half; the fit and prediction
are ``tests/test_torch_parallel_fit.py``), plus ``tests/test_mice_device.py``'s
mesh test, with ``mogp_tpu``'s tolerances: implausibility ``rtol`` 1e-8
and an equal NROY set.  Within the port, a sharded run equals the
unsharded one bit for bit where a lane's arithmetic does not depend on its
batch (the NUTS chains, the SMC particles, the MICE points and scores),
and the sharded history matching, whose query axis the CPU's products
round by its size, within the tolerance.  History matching and MICE are
also held against ``mogp_tpu``'s own mesh path on 8 virtual CPU devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.parallel import auto_mesh as jax_mesh  # noqa: E402
from mogp_tpu_torch import GaussianProcess, MultiOutputGP, fit_GP_MAP  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402
from mogp_tpu_torch.parallel import DeviceMesh, auto_mesh  # noqa: E402
from mogp_tpu_torch.uq import history_matching as thm  # noqa: E402
from mogp_tpu_torch.uq import mice_device as tmd  # noqa: E402

torch.set_num_threads(2)

rng = np.random.RandomState(0)
X = rng.rand(16, 3)
YS = np.stack([np.sin((k + 1) * X[:, 0]) + X[:, 1] for k in range(8)])


def cpu_mesh(n, **kw):
    return auto_mesh(n, device="cpu", **kw)


@pytest.fixture
def threaded(monkeypatch):
    """Mark every mesh threaded, as a mesh of distinct cards is."""
    monkeypatch.setattr(DeviceMesh, "threaded", property(lambda self: True))


# -- history matching ---------------------------------------------------------------

def _hm_problem():
    r = np.random.RandomState(5)
    x = r.uniform(size=(18, 2))
    y = np.stack([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1])])
    return x, y, r.uniform(size=(41, 2)), [[0.5, 0.2], [0.01, 0.01]]


@pytest.fixture(scope="module")
def hm_pair():
    x, y, coords, obs = _hm_problem()
    np.random.seed(9)
    mgp = fit_GP_MAP(MultiOutputGP(x, y, nugget="adaptive", device="cpu"), n_tries=2,
                     maxiter=30)
    jgp = mogp_tpu.MultiOutputGP(x, y, nugget="adaptive")
    jgp.fit(np.stack([em.theta.get_data() for em in mgp.emulators]))
    return mgp, jgp, coords, obs


@pytest.mark.parametrize("sweep", [False, True], ids=["host", "device_sweep"])
def test_sharded_history_matching_mogp(hm_pair, monkeypatch, sweep):
    """The host path (41 coords, below the sweep's threshold) and the device
    sweep (forced): I within 1e-8 of the unsharded, the same NROY.  Against
    mogp_tpu's mesh path: within the two packages' own unsharded gap (2.1e-7
    relative here: the adaptive nuggets are 0 and sum |K^-1 y| is 1.7e6, so
    the packages' last-ulp differences in K* show), the same NROY."""
    mgp, jgp, coords, obs = hm_pair
    if sweep:
        monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    hm_mesh = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords,
                                             mesh=cpu_mesh(8, axis_names=("data",)))
    local = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords)
    I, I_local = hm_mesh.get_implausibility(), local.get_implausibility()
    assert_allclose(I, I_local, rtol=1e-8)
    assert hm_mesh.get_NROY() == local.get_NROY()
    ref = mogp_tpu.HistoryMatching(gp=jgp, obs=obs, coords=coords, mesh=jax_mesh(8))
    gap = np.abs(I_local - mogp_tpu.HistoryMatching(gp=jgp, obs=obs,
                                                    coords=coords).get_implausibility())
    I_ref = ref.get_implausibility()
    assert np.all(np.abs(I - I_ref) <= 1e-8 * np.abs(I_ref) + 2 * gap)
    assert hm_mesh.get_NROY() == [int(i) for i in ref.get_NROY()]


def test_sharded_device_sweep_splits_the_coords(hm_pair, monkeypatch):
    """Each shard sweeps its consecutive share, on its own device; the merge
    of the shards' top-k equals the sweep of the shares concatenated."""
    mgp, _, coords, obs = hm_pair
    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    seen = []
    sweep = thm.HistoryMatching._sweep_topk

    def spy(self, c, disc, k, device=None):
        seen.append((c.shape[0], device))
        return sweep(self, c, disc, k, device)

    monkeypatch.setattr(thm.HistoryMatching, "_sweep_topk", spy)
    hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords, mesh=cpu_mesh(4))
    I = hm.get_implausibility(rank=0)
    assert seen == [(11, torch.device("cpu"))] + [(10, torch.device("cpu"))] * 3
    parts = [slice(0, 11), slice(11, 21), slice(21, 31), slice(31, 41)]
    alone = np.concatenate([mogp_tpu_torch.HistoryMatching(
        gp=mgp, obs=obs, coords=coords[p]).get_implausibility(rank=0) for p in parts])
    assert np.array_equal(I, alone)


def test_sharded_device_sweep_on_threads(hm_pair, monkeypatch):
    """The shards on threads of their own give the shards in turn's I."""
    mgp, _, coords, obs = hm_pair
    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    in_turn = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords,
                                             mesh=cpu_mesh(4)).get_implausibility()
    monkeypatch.setattr(DeviceMesh, "threaded", property(lambda self: True))
    on_threads = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=obs, coords=coords,
                                                mesh=cpu_mesh(4)).get_implausibility()
    assert np.array_equal(on_threads, in_turn)


def test_sharded_history_matching_single_gp():
    np.random.seed(11)
    gp = fit_GP_MAP(GaussianProcess(X, YS[0], device="cpu"), n_tries=2)
    coords = rng.rand(30, 3)
    hm_mesh = mogp_tpu_torch.HistoryMatching(gp=gp, obs=[1.0, 0.01], coords=coords,
                                             mesh=cpu_mesh(4))
    hm_local = mogp_tpu_torch.HistoryMatching(gp=gp, obs=[1.0, 0.01], coords=coords)
    assert_allclose(hm_mesh.get_implausibility(), hm_local.get_implausibility(), rtol=1e-8)
    assert hm_mesh.get_NROY() == hm_local.get_NROY()


# -- SMC ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smc_gp():
    np.random.seed(11)
    x = np.random.rand(30, 2) * 4 - 2
    y = x[:, 0] ** 2 + x[:, 1] ** 2
    return fit_GP_MAP(GaussianProcess(x, y, nugget=1e-6, device="cpu"), n_tries=8)


def test_smc_with_mesh(smc_gp):
    """tests/test_parallel.py's case; the particles and I equal the
    unsharded run's: the draws stay on the emulator's device and a
    prediction does not depend on the other queries of its batch."""
    kw = dict(obs=[1.0, 0.01], bounds=[[-2, 2], [-2, 2]], n_particles=512, n_stages=5,
              n_mcmc=2, seed=0)
    res = mogp_tpu_torch.smc_history_match(smc_gp, mesh=cpu_mesh(8), **kw)
    assert res.particles.shape == (512, 2)
    assert res.nroy_fraction > 0.5
    ref = mogp_tpu_torch.smc_history_match(smc_gp, **kw)
    assert_allclose(res.particles, ref.particles, rtol=1e-6)
    assert_allclose(res.implausibility, ref.implausibility, rtol=1e-6)
    assert np.array_equal(res.thresholds, ref.thresholds)


def test_smc_mogp_with_mesh_on_threads(threaded):
    r = np.random.RandomState(13)
    x = r.uniform(-2, 2, size=(25, 2))
    y = np.stack([x[:, 0] ** 2 + x[:, 1], np.sin(x[:, 0]) + x[:, 1] ** 2, x[:, 0] * x[:, 1]])
    np.random.seed(13)
    mgp = fit_GP_MAP(MultiOutputGP(x, y, nugget=1e-6, device="cpu"), n_tries=3, maxiter=40)
    kw = dict(obs=[[1.0, 1.0, 0.5], [0.01, 0.01, 0.01]], bounds=[[-2, 2], [-2, 2]],
              n_particles=300, n_stages=3, n_mcmc=2, seed=3)
    res = mogp_tpu_torch.smc_history_match(mgp, mesh=cpu_mesh(4), **kw)
    ref = mogp_tpu_torch.smc_history_match(mgp, **kw)
    assert_allclose(res.particles, ref.particles, rtol=1e-6)
    assert_allclose(res.implausibility, ref.implausibility, rtol=1e-6)


# -- NUTS -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nuts_gp():
    np.random.seed(12)
    return fit_GP_MAP(GaussianProcess(X, YS[0], nugget="fit", device="cpu"), n_tries=2)


@pytest.mark.parametrize("n_dev", [4, 3])
def test_sharded_mcmc_chains(nuts_gp, n_dev):
    """Chains split over the mesh (3 does not divide 4: shares of 2, 1, 1);
    each chain keeps its global stream, so the samples are the unsharded
    run's bit for bit."""
    kw = dict(n_samples=12, n_warmup=12, n_chains=4, theta0=nuts_gp.theta.get_data(),
              max_depth=5)
    res = mogp_tpu_torch.sample_GP_MCMC(nuts_gp, mesh=cpu_mesh(n_dev), **kw)
    assert res.samples.shape == (4, 12, nuts_gp.n_params)
    assert np.all(np.isfinite(res.samples))
    ref = mogp_tpu_torch.sample_GP_MCMC(nuts_gp, **kw)
    assert np.array_equal(res.samples, ref.samples)
    assert np.array_equal(res.accept_prob, ref.accept_prob)


def test_sharded_mcmc_on_threads_with_checkpoints(nuts_gp, tmp_path, threaded):
    """Threads of their own, and each shard its own checkpoint file, which
    is removed on completion."""
    kw = dict(n_samples=6, n_warmup=6, n_chains=4, seed=2, theta0=nuts_gp.theta.get_data(),
              max_depth=5)
    ref = mogp_tpu_torch.sample_GP_MCMC(nuts_gp, **kw)
    res = mogp_tpu_torch.sample_GP_MCMC(nuts_gp, mesh=cpu_mesh(2),
                                        checkpoint_path=str(tmp_path / "run"), **kw)
    assert np.array_equal(res.samples, ref.samples)
    assert list(tmp_path.iterdir()) == []


def test_sharded_mcmc_checkpoint_resume(nuts_gp, tmp_path, monkeypatch):
    """A preempted sharded run resumes each shard from its own file."""
    kw = dict(n_samples=8, n_warmup=4, n_chains=4, seed=5, theta0=nuts_gp.theta.get_data(),
              segment=4, mesh=cpu_mesh(2), max_depth=5)
    ref = mogp_tpu_torch.sample_GP_MCMC(nuts_gp, **kw)
    orig = tinf._nuts_sample_seg
    calls = {"n": 0}

    def preempt(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:   # shard 0 done, shard 1 one segment in
            raise RuntimeError("preempted")
        return orig(*a, **k)

    monkeypatch.setattr(tinf, "_nuts_sample_seg", preempt)
    with pytest.raises(RuntimeError, match="preempted"):
        mogp_tpu_torch.sample_GP_MCMC(nuts_gp, checkpoint_path=str(tmp_path / "c"), **kw)
    monkeypatch.setattr(tinf, "_nuts_sample_seg", orig)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.shard1.npz"]
    res = mogp_tpu_torch.sample_GP_MCMC(nuts_gp, checkpoint_path=str(tmp_path / "c"), **kw)
    assert np.array_equal(res.samples, ref.samples)
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def nuts_mgp():
    kernels = ["SquaredExponential", "Matern52", "SquaredExponential", "SquaredExponential",
               "SquaredExponential"]
    np.random.seed(4)
    return fit_GP_MAP(MultiOutputGP(X, YS[:5], kernel=list(kernels), nugget="fit",
                                    device="cpu"), n_tries=2, maxiter=30)


def test_mogp_mcmc_heterogeneous_with_mesh(nuts_mgp, monkeypatch):
    """Per signature group: the SqExp group of 4 outputs splits over a mesh
    of 2 (2 outputs x 2 chains a shard), the Matern group of 1 stays whole;
    the results equal the unsharded run's."""
    shards = []
    run = tinf._run_nuts_chains

    def spy(data, q0, *a, **k):
        shards.append(q0.shape[0])
        return run(data, q0, *a, **k)

    monkeypatch.setattr(tinf, "_run_nuts_chains", spy)
    kw = dict(n_samples=6, n_warmup=6, n_chains=2, seed=0, max_depth=5)
    res = mogp_tpu_torch.sample_MOGP_MCMC(nuts_mgp, mesh=cpu_mesh(2), **kw)
    assert shards == [4, 4, 2]
    ref = mogp_tpu_torch.sample_MOGP_MCMC(nuts_mgp, **kw)
    assert len(res) == 5
    for a, b in zip(res, ref):
        assert a.samples.shape == (2, 6, b.samples.shape[-1])
        assert np.all(np.isfinite(a.samples))
        assert np.array_equal(a.samples, b.samples)


# -- MICE ---------------------------------------------------------------------------

def _run_design(pkg, seed=42, **kw):
    np.random.seed(seed)
    ed = pkg.LatinHypercubeDesign([(0.0, 1.0), (0.0, 1.0)])

    def f(x):
        return np.sin(4 * x[0]) + x[1] ** 2

    if pkg is mogp_tpu_torch:
        kw = dict(kw, device="cpu")
    md = pkg.DeviceMICEDesign(ed, f, n_samples=4, n_init=6, n_cand=16, n_tries=4, maxiter=50,
                              **kw)
    md.run_sequential_design()
    return md


def test_device_mice_mesh_scoring_matches_local(monkeypatch):
    """tests/test_mice_device.py's mesh case: 2 blocks of 8 padded to 8
    blocks (fully masked) over 8 shards, one block each; the same points and
    scores as the unsharded loop and as mogp_tpu's mesh path."""
    blocks = []
    score = tmd._mice_score_step

    def spy(raw, data, mask, cand_blocks, *a):
        blocks.append(cand_blocks.shape[0])
        return score(raw, data, mask, cand_blocks, *a)

    local = _run_design(mogp_tpu_torch, cand_block=8)
    monkeypatch.setattr(tmd, "_mice_score_step", spy)
    mesh = _run_design(mogp_tpu_torch, cand_block=8, mesh=cpu_mesh(8))
    assert mesh._n_cand_pad == 64 and set(blocks) == {1} and len(blocks) == 4 * 8
    assert np.array_equal(mesh.inputs, local.inputs)
    assert_allclose(mesh._last_scores, local._last_scores, rtol=1e-9)
    ref = _run_design(mogp_tpu, cand_block=8, mesh=jax_mesh(8))
    assert_allclose(mesh.inputs, ref.inputs, rtol=1e-12)
    assert_allclose(mesh._last_scores, ref._last_scores, rtol=1e-7)


def test_device_mice_mesh_on_threads(threaded):
    local = _run_design(mogp_tpu_torch, cand_block=4)
    mesh = _run_design(mogp_tpu_torch, cand_block=4, mesh=cpu_mesh(3))
    assert mesh._n_cand_pad == 24
    assert np.array_equal(mesh.inputs, local.inputs)
    assert np.array_equal(mesh._last_scores, local._last_scores)
