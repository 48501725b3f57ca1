"""The port's SMC history matching (``uq/smc.py``) against ``mogp_tpu``.

Given the same numbers the two packages agree: systematic resampling with
the same uniform offset (the same indices), and the implausibility of a
``GaussianProcess`` and of a ``MultiOutputGP`` at rank 0 and 1 (within
1e-10 of the largest I: float64 predictions of the same fitted emulators;
``|z - mu|`` cancels near the observation, so not 1e-10 of each I).  A
standardized emulator gives the implausibility of its unstandardized twin.
The anneal's random stream is the port's own, so it is held to the
statistical assertions of ``tests/test_uq.py``; a checkpointed run equals
the run without one, and a run preempted after a stage resumes to it, bit
for bit, from a path with or without ``.npz``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.uq import smc as jsmc  # noqa: E402
from mogp_tpu_torch.uq import smc as tsmc  # noqa: E402
from mogp_tpu_torch.utils import checkpoint as ckpt_mod  # noqa: E402

torch.set_num_threads(2)


def test_systematic_resample_matches_jax():
    rng = np.random.RandomState(0)
    for k, w in enumerate([np.array([0.0, 0.5, 0.5, 0.0]), rng.uniform(size=50),
                           (rng.uniform(size=300) < 0.2) + 1e-12]):
        key = jax.random.PRNGKey(k)
        ref = np.asarray(jsmc.systematic_resample(key, jnp.asarray(w), 257))
        u = torch.tensor(float(jax.random.uniform(key)), dtype=torch.float64)
        got = tsmc.systematic_resample(u, torch.as_tensor(w), 257).numpy()
        np.testing.assert_array_equal(got, ref)


def test_systematic_resample():
    """Port of ``tests/test_uq.py::test_systematic_resample``."""
    w = torch.tensor([0.0, 0.5, 0.5, 0.0], dtype=torch.float64)
    idx = tsmc.systematic_resample(torch.rand((), generator=torch.Generator().manual_seed(0),
                                              dtype=torch.float64), w, 100).numpy()
    assert set(idx.tolist()) <= {1, 2}
    assert abs(np.bincount(idx, minlength=4)[1] - 50) <= 1
    # a position past the rounded total is clamped to the last particle
    last = tsmc.systematic_resample(torch.tensor(1.0 - 1e-17, dtype=torch.float64),
                                    torch.ones(3, dtype=torch.float64) / 3, 3)
    assert int(last.max()) <= 2


def _pair_gp():
    np.random.seed(11)
    x = np.random.rand(40, 2) * 4 - 2
    y = x[:, 0] ** 2 + x[:, 1] ** 2 + 0.05 * np.random.randn(40)
    tg = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.GaussianProcess(x, y, nugget="fit",
                                                                  device="cpu"), n_tries=3)
    jg = mogp_tpu.GaussianProcess(x, y, nugget="fit")
    jg.fit(tg.theta.get_data())
    return tg, jg


def _pair_mogp(n_out=3):
    rng = np.random.RandomState(12)
    x = rng.rand(30, 2) * 4 - 2
    ys = np.stack([(x[:, 0] - 0.2 * i) ** 2 + x[:, 1] ** 2 + 0.05 * rng.randn(30)
                   for i in range(n_out)])
    np.random.seed(0)
    tm = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(x, ys, nugget="fit",
                                                                device="cpu"), n_tries=2)
    jm = mogp_tpu.MultiOutputGP(x, ys, nugget="fit")
    jm.fit([em.theta.get_data() for em in tm.emulators])
    return tm, jm


def _close(got, ref):
    assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.max(np.abs(ref)))


def _queries(n=200, seed=3):
    return np.random.RandomState(seed).uniform(-2.5, 2.5, size=(n, 2))


@pytest.mark.parametrize("include_nugget", [True, False])
def test_implausibility_of_a_gp_matches_jax(include_nugget):
    tg, jg = _pair_gp()
    q = _queries()
    got = tsmc._make_implausibility_fn(tg, 1.0, 0.01, 0.05, include_nugget)(torch.as_tensor(q))
    ref = jsmc._make_implausibility_fn(jg, jnp.asarray(1.0), jnp.asarray(0.01),
                                       jnp.asarray(0.05), include_nugget)(jnp.asarray(q))
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("rank", [0, 1])
def test_implausibility_of_a_mogp_matches_jax(rank):
    tm, jm = _pair_mogp()
    obs_mean, obs_var = np.array([1.0, 0.8, 1.3]), np.array([0.01, 0.02, 0.03])
    q = _queries()
    got = tsmc._make_implausibility_fn(tm, obs_mean, obs_var, 0.0, True, rank=rank)(
        torch.as_tensor(q))
    ref = jsmc._make_implausibility_fn(jm, jnp.asarray(obs_mean), jnp.asarray(obs_var),
                                       jnp.asarray(0.0), True, rank=rank)(jnp.asarray(q))
    _close(got.numpy(), np.asarray(ref))


def test_standardized_emulator_gives_its_twin_implausibility():
    """``standardize=[True, False, True]`` against an unstandardized twin at
    the hyperparameters that make the same model: a constant mean absorbs
    the shift, sigma^2 and the nugget take the scale squared."""
    rng = np.random.RandomState(4)
    x = rng.rand(30, 2) * 4 - 2
    ys = np.stack([3.0 + 5.0 * np.sin(x[:, 0]) + x[:, 1], x[:, 0] * x[:, 1],
                   -2.0 + 0.1 * x[:, 0] ** 2 + 0.01 * rng.randn(30)])
    kw = dict(mean="1", nugget="fit", device="cpu")
    std = mogp_tpu_torch.MultiOutputGP(x, ys, standardize=[True, False, True], **kw)
    twin = mogp_tpu_torch.MultiOutputGP(x, ys, **kw)
    thetas = [np.array([0.5, -0.3, 0.2, -6.0]), np.array([0.1, 0.4, 0.7, -5.0]),
              np.array([-0.2, 0.3, -0.1, -4.0])]
    std.fit(thetas)
    twin.fit([t + np.array([0.0, 0.0, 2.0, 2.0]) * np.log(em._t_std)
              for t, em in zip(thetas, std.emulators)])
    obs_mean, obs_var = np.array([4.0, 0.5, -1.9]), np.array([0.1, 0.01, 0.001])
    q = torch.as_tensor(_queries(300, 5))
    for rank in (0, 1):
        got = tsmc._make_implausibility_fn(std, obs_mean, obs_var, 0.02, True, rank)(q)
        ref = tsmc._make_implausibility_fn(twin, obs_mean, obs_var, 0.02, True, rank)(q)
        _close(got.numpy(), ref.numpy())
    one = mogp_tpu_torch.GaussianProcess(x, ys[0], standardize=True, **kw)
    one.fit(thetas[0])
    got = tsmc._make_implausibility_fn(one, 4.0, 0.1, 0.02, True)(q)
    ref = tsmc._make_implausibility_fn(twin.emulators[0], 4.0, 0.1, 0.02, True)(q)
    _close(got.numpy(), ref.numpy())


# -- statistical ports of tests/test_uq.py ------------------------------------

@pytest.fixture(scope="module")
def paraboloid():
    np.random.seed(11)
    x = np.random.rand(40, 2) * 4 - 2
    y = x[:, 0] ** 2 + x[:, 1] ** 2
    return mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(x, y, nugget=1e-6, device="cpu"), n_tries=10)


def test_smc_history_match_concentrates_on_nroy(paraboloid):
    """Paraboloid target with obs=1: NROY is the ring r~1; SMC particles
    must concentrate there."""
    res = mogp_tpu_torch.smc_history_match(
        paraboloid, obs=[1.0, 0.01], bounds=[[-2, 2], [-2, 2]],
        n_particles=1024, n_stages=6, n_mcmc=3, seed=0,
    )
    r = np.sqrt(np.sum(res.particles**2, axis=1))
    assert res.nroy_fraction > 0.95
    assert abs(r.mean() - 1.0) < 0.1
    assert r.std() < 0.2
    # thresholds anneal down to the target
    assert res.thresholds[-1] == pytest.approx(3.0)


def test_smc_multioutput():
    """Multi-output SMC: two paraboloid-family outputs; the NROY set is
    the intersection ring."""
    np.random.seed(12)
    x = np.random.rand(50, 2) * 4 - 2
    ys = np.stack([
        x[:, 0] ** 2 + x[:, 1] ** 2,
        (x[:, 0] - 0.2) ** 2 + x[:, 1] ** 2,
    ])
    mgp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.MultiOutputGP(x, ys, nugget=1e-6, device="cpu"), n_tries=8)
    res = mogp_tpu_torch.smc_history_match(
        mgp, obs=[np.array([1.0, 1.0]), np.array([0.01, 0.01])],
        bounds=[[-2, 2], [-2, 2]], n_particles=512, n_stages=6,
        n_mcmc=2, rank=0, seed=0,
    )
    assert res.particles.shape == (512, 2)
    assert res.nroy_fraction > 0.8
    r = np.sqrt(np.sum(res.particles**2, axis=1))
    assert abs(r.mean() - 1.0) < 0.2


@pytest.mark.parametrize("name", ["smc.npz", "smc"])
def test_smc_checkpoint_resume_identity(tmp_path, monkeypatch, paraboloid, name):
    """A checkpointed anneal equals the anneal without one, and a run
    preempted after stage 2 resumes to the same population, bit for bit;
    a checkpoint of another configuration is ignored."""
    kwargs = dict(obs=[1.0, 0.01], bounds=[[-2, 2], [-2, 2]], n_particles=256, n_stages=5,
                  n_mcmc=2, seed=3)
    res_single = mogp_tpu_torch.smc_history_match(paraboloid, **kwargs)
    p = str(tmp_path / name)
    written = str(tmp_path / "smc.npz")
    res_ckpt = mogp_tpu_torch.smc_history_match(paraboloid, checkpoint_path=p, **kwargs)
    assert not os.path.exists(written)  # removed on completion
    np.testing.assert_array_equal(res_ckpt.particles, res_single.particles)
    np.testing.assert_array_equal(res_ckpt.thresholds, res_single.thresholds)
    np.testing.assert_array_equal(res_ckpt.accept_rates, res_single.accept_rates)

    # preempt after stage 2: save_smc raises after persisting stage 2
    real_save = ckpt_mod.save_smc

    def failing_save(filename, state, tag=""):
        real_save(filename, state, tag=tag)
        if int(state["stage"]) == 2:
            raise RuntimeError("preempted")

    monkeypatch.setattr(ckpt_mod, "save_smc", failing_save)
    with pytest.raises(RuntimeError, match="preempted"):
        mogp_tpu_torch.smc_history_match(paraboloid, checkpoint_path=p, **kwargs)
    monkeypatch.setattr(ckpt_mod, "save_smc", real_save)
    assert os.path.exists(written)
    saved = ckpt_mod.load_smc(p)
    assert saved["stage"] == 2 and list(saved["key"]) == [3, 2]

    res_resumed = mogp_tpu_torch.smc_history_match(paraboloid, checkpoint_path=p, **kwargs)
    np.testing.assert_array_equal(res_resumed.particles, res_ckpt.particles)
    np.testing.assert_array_equal(res_resumed.thresholds, res_ckpt.thresholds)
    np.testing.assert_array_equal(res_resumed.implausibility, res_ckpt.implausibility)

    # a checkpoint from a different run configuration is rejected
    real_save(p, saved, tag="stale-tag")
    with pytest.warns(UserWarning, match="different run"):
        res_fresh = mogp_tpu_torch.smc_history_match(paraboloid, checkpoint_path=p, **kwargs)
    np.testing.assert_array_equal(res_fresh.particles, res_ckpt.particles)
