"""History matching of the port against ``mogp_tpu``.

Every case of ``tests/test_history_matching.py`` that has a counterpart in
the port runs through both packages on the same inputs: the results must
agree (float64 on both sides, the same numpy reductions: to rounding,
``rtol`` 1e-12) and the failures must be the same exceptions.  Then the
device sweep: forced through ``_DEVICE_SWEEP_MIN_COORDS``, it must equal
the host path (and ``mogp_tpu``'s), bring no ``(G, n_query)`` prediction
to the host, and tile without changing a value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.uq import history_matching as jhm  # noqa: E402
from mogp_tpu_torch.uq import history_matching as thm  # noqa: E402

torch.set_num_threads(2)

PKGS = [mogp_tpu, mogp_tpu_torch]
RTOL = 1e-12


def _kw(pkg):
    return {"device": "cpu"} if pkg is mogp_tpu_torch else {}


def _exp(pkg, mean, unc):
    return pkg.PredictResult(mean=np.asarray(mean, dtype=float), unc=np.asarray(unc, dtype=float),
                             deriv=None)


def _exp_1out(pkg, ncoords=5, seed=0):
    rng = np.random.RandomState(seed)
    return _exp(pkg, rng.uniform(-1.0, 1.0, size=ncoords), rng.uniform(0.01, 0.2, size=ncoords))


def _both(case):
    """Run ``case(pkg)`` for both packages; return both results."""
    return [case(pkg) for pkg in PKGS]


def _same(case):
    a, b = _both(case)
    assert_allclose(np.asarray(b, dtype=float), np.asarray(a, dtype=float), rtol=RTOL)
    return b


def _same_raise(case, exc):
    for pkg in PKGS:
        with pytest.raises(exc):
            case(pkg)


def test_observation_conventions():
    for obs in (1.5, [2.0], [2.0, 0.25], [np.array([1.0, 2.0, 3.0]), np.array([0.1, 0.2, 0.3])]):
        a, b = _both(lambda pkg: pkg.HistoryMatching(obs=obs))
        assert b.get_n_obs() == a.get_n_obs()
        for x, y in zip(a.obs, b.obs):
            assert_allclose(y, x, rtol=0)
    for obs, exc in [([], ValueError), ([1.0, 2.0, 3.0], ValueError), ([1.0, -0.5], AssertionError),
                     ([np.array([1.0, 2.0]), np.array([0.1])], AssertionError)]:
        _same_raise(lambda pkg: pkg.HistoryMatching(obs=obs), exc)


def test_implausibility_oracles():
    # single output with discrepancy
    _same(lambda pkg: pkg.HistoryMatching(obs=[0.3, 0.04], expectations=_exp_1out(pkg, 6, 1))
          .get_implausibility(0.02))
    # zero observation and discrepancy variances
    I = _same(lambda pkg: pkg.HistoryMatching(
        obs=1.0, expectations=_exp(pkg, [0.0, 1.0, 2.0], [1.0, 4.0, 0.25])).get_implausibility())
    assert_allclose(I, [1.0, 0.0, 2.0])
    # multi-output rank selection and per-output discrepancy
    means = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 3.0, 4.0], [2.0, 1.0, 0.5, 0.25]])
    for rank in (0, 1, 2):
        _same(lambda pkg: pkg.HistoryMatching(
            obs=[np.zeros(3), np.zeros(3)], expectations=_exp(pkg, means, np.ones((3, 4))))
            .get_implausibility(rank=rank))
    _same(lambda pkg: pkg.HistoryMatching(
        obs=[np.zeros(2), np.zeros(2)],
        expectations=_exp(pkg, [[1.0, 2.0], [3.0, 4.0]], np.full((2, 2), 0.5)))
        .get_implausibility(np.array([0.5, 1.5]), rank=0))


def test_implausibility_failures():
    def rank_bound(rank):
        return lambda pkg: pkg.HistoryMatching(
            obs=[np.zeros(2), np.ones(2)],
            expectations=_exp(pkg, np.zeros((2, 3)), np.ones((2, 3)))).get_implausibility(rank=rank)

    _same_raise(rank_bound(2), AssertionError)
    _same_raise(rank_bound(-1), AssertionError)
    _same_raise(lambda pkg: pkg.HistoryMatching(obs=1.0, expectations=_exp_1out(pkg))
                .get_implausibility(-0.1), AssertionError)
    _same_raise(lambda pkg: pkg.HistoryMatching(expectations=_exp_1out(pkg)).get_implausibility(),
                ValueError)
    _same_raise(lambda pkg: pkg.HistoryMatching(obs=1.0).get_implausibility(), ValueError)

    def both_sources(pkg):
        rng = np.random.RandomState(3)
        x = rng.rand(12, 2)
        gp = pkg.GaussianProcess(x, np.sin(x[:, 0]), nugget=1e-6, **_kw(pkg))
        gp.fit(np.zeros(gp.n_params))
        return pkg.HistoryMatching(gp=gp, obs=0.5, coords=rng.rand(4, 2),
                                   expectations=_exp_1out(pkg, 4)).get_implausibility()

    _same_raise(both_sources, ValueError)


def test_nroy_ro():
    def partition(pkg):
        hm = pkg.HistoryMatching(obs=[0.0, 0.1], expectations=_exp_1out(pkg, 40, 4), threshold=1.0)
        return hm.get_NROY(), hm.get_RO()

    (nj, rj), (nt, rt) = _both(partition)
    assert nt == nj and rt == rj
    assert sorted(nt + rt) == list(range(40))

    def end_to_end(pkg):
        rng = np.random.RandomState(6)
        x = rng.rand(25, 1)
        gp = pkg.GaussianProcess(x, 2.0 * x[:, 0], nugget=1e-6, **_kw(pkg))
        gp.fit(np.array([0.0, 0.0]))
        hm = pkg.HistoryMatching(gp=gp, obs=[1.0, 1e-4], coords=np.linspace(0.0, 1.0, 21)[:, None])
        return hm.get_implausibility(), hm.get_NROY()

    (Ij, nj), (It, nt) = _both(end_to_end)
    assert_allclose(It, Ij, rtol=1e-9)
    assert nt == nj and len(nt) > 0


def test_setters_checks_update_and_str():
    for pkg in PKGS:
        hm = pkg.HistoryMatching()
        assert hm.threshold == 3.0
        with pytest.raises(TypeError):
            hm.set_gp("not a gp")
        hm.set_coords(np.ones(5))
        assert hm.coords.shape == (5, 1) and hm.ndim == 1 and hm.ncoords == 5
        hm.set_coords([1.0, 2.0, 3.0])
        assert hm.coords.shape == (3, 1)
        hm.set_coords(None)
        assert hm.coords is None
        for bad in (np.ones((2, 2, 2)), "abc"):
            with pytest.raises(TypeError):
                hm.set_coords(bad)
        hm.set_expectations(_exp_1out(pkg, 4))
        assert hm.ncoords == 4
        hm.set_expectations(None)
        with pytest.raises(ValueError):
            hm.set_expectations(_exp(pkg, np.zeros(3), np.zeros(4)))
        with pytest.raises(AssertionError):
            hm.set_expectations(_exp(pkg, np.zeros(3), -np.ones(3)))
        with pytest.raises(TypeError):
            hm.set_expectations("bad")
        hm.set_threshold(5)
        assert hm.threshold == 5.0
        with pytest.raises(AssertionError):
            hm.set_threshold(-1.0)
        with pytest.raises(TypeError):
            hm.set_threshold([3.0])
        hm = pkg.HistoryMatching(expectations=_exp(pkg, np.zeros((3, 7)), np.ones((3, 7))))
        assert hm.ncoords == 7
    a, b = _both(lambda pkg: str(pkg.HistoryMatching(obs=[1.0, 0.1],
                                                     expectations=_exp_1out(pkg, 4))))
    assert b == a and "I_threshold: 3.0" in b


def test_mesh_is_refused():
    """A ``mesh`` that is not a ``parallel.DeviceMesh`` raises."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        mogp_tpu_torch.HistoryMatching(obs=1.0, mesh=object())


# -- the device sweep --------------------------------------------------------

KERNELS = ["SquaredExponential", "Matern52", "SquaredExponential", "Matern52"]


def _mogp(pkg, seed=17):
    """Four outputs in two kernel groups, fit at seeded hyperparameters."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(size=(18, 2))
    y = np.stack([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1]), x[:, 0] * x[:, 1], x[:, 0] ** 2])
    mgp = pkg.MultiOutputGP(x, y, kernel=KERNELS, **_kw(pkg))
    mgp.fit(np.column_stack([rng.uniform(-1, 1, size=(4, 2)), rng.uniform(-0.5, 0.5, size=4)]))
    return mgp, rng.uniform(size=(531, 2))


OBS = [[0.4, 0.3, 0.2, 0.25], [0.01, 0.02, 0.015, 0.01]]


@pytest.mark.parametrize("rank,disc", [(1, 0.0), (0, 0.05), (2, [0.01, 0.0, 0.02, 0.0])])
def test_device_sweep_matches_host_and_mogp_tpu(monkeypatch, rank, disc):
    """tests/test_history_matching.py:291-328 on the port: the sweep forced
    on equals the host path forced on, and both equal mogp_tpu's.  While
    the sweep runs, MultiOutputGP.predict (the host path's (G, n_query)
    arrays) must not be called."""
    mj, coords = _mogp(mogp_tpu)
    mt, _ = _mogp(mogp_tpu_torch)
    monkeypatch.setattr(jhm, "_DEVICE_SWEEP_MIN_COORDS", 10**12)
    I_ref = mogp_tpu.HistoryMatching(gp=mj, obs=OBS, coords=coords).get_implausibility(disc, rank)

    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 10**12)
    I_host = mogp_tpu_torch.HistoryMatching(gp=mt, obs=OBS, coords=coords).get_implausibility(
        disc, rank)
    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    hm = mogp_tpu_torch.HistoryMatching(gp=mt, obs=OBS, coords=coords)

    def refuse(*args, **kw):
        raise AssertionError("the device sweep called MultiOutputGP.predict")

    monkeypatch.setattr(mt, "predict", refuse)
    I_dev = hm.get_implausibility(disc, rank)
    assert I_dev.shape == (531,) and I_dev.dtype == np.float64
    assert_allclose(I_dev, I_host, rtol=1e-12, atol=1e-14)
    assert_allclose(I_dev, I_ref, rtol=1e-9, atol=1e-12)
    assert hm.get_NROY() == list(np.where(I_ref <= 3.0)[0])
    assert sorted(hm.get_NROY() + hm.get_RO()) == list(range(531))


def test_device_sweep_tiles_and_paths(monkeypatch):
    """The tiled top-k equals one untiled call; an unfit emulator or a
    single GP keeps the host path; below the threshold the host path
    runs."""
    mt, coords = _mogp(mogp_tpu_torch)
    t = mt.emulators[0]._tensor

    def tiles(max_batch_size):
        (rows, parts, _, _), = mt._predict_groups(coords, [0, 2], max_batch_size=max_batch_size)
        assert rows == [0, 2]
        return list(parts)

    (mu, var), = tiles(None)
    tiled = tiles(100)  # rounded up to tiles of 256: 256, 256 and 19 points
    assert [p[0].shape[1] for p in tiled] == [256, 256, 19]
    # the tiles' matrix products sum in other orders: the predictions (of
    # scale ~1) agree to rounding amplified by K's condition, the 1e-10 of
    # test_torch_validation's PRED_ATOL (2.1e-12 seen)
    for i, whole_part in enumerate((mu, var)):
        assert_allclose(torch.cat([p[i] for p in tiled], 1).numpy(), whole_part.numpy(), rtol=0,
                        atol=1e-10)

    obs_mean, obs_var = t([0.4, 0.2]), t([0.01, 0.015])
    whole = thm._implausibility_topk([(mu, var)], obs_mean, obs_var, 2)
    chunks = [(mu[:, c:c + 100], var[:, c:c + 100]) for c in range(0, 531, 100)]
    assert whole.shape == (2, 531)
    assert_allclose(thm._implausibility_topk(chunks, obs_mean, obs_var, 2).numpy(), whole.numpy(),
                    rtol=1e-13)
    assert bool((whole[0] >= whole[1]).all())

    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    hm = mogp_tpu_torch.HistoryMatching(gp=mt, obs=OBS, coords=coords)
    assert hm._device_sweep_applies()
    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 532)
    assert not hm._device_sweep_applies()
    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    single = mogp_tpu_torch.HistoryMatching(gp=mt.emulators[0], obs=0.4, coords=coords)
    assert not single._device_sweep_applies()
    mt.emulators[3].theta = None
    assert not hm._device_sweep_applies()
    with pytest.raises(ValueError, match="not been fit"):
        hm.get_implausibility()  # the host path's predict, as in mogp_tpu


@pytest.mark.parametrize("rank", [0, 1])
def test_device_sweep_maps_standardized_emulators(monkeypatch, rank):
    """A MultiOutputGP with standardize=[True, False, True, False] (the
    JAX package has no such option) and targets far from 0 and 1: the sweep
    forced on equals the host path and the implausibility built by hand from
    each emulator's own GaussianProcess.predict, both in the targets'
    units, to 1e-12."""
    rng = np.random.RandomState(31)
    x = rng.uniform(size=(18, 2))
    y = np.stack([40 + 7 * np.sin(3 * x[:, 0]), 0.5 * np.cos(2 * x[:, 1]),
                  -25 + 3 * x[:, 0] * x[:, 1], x[:, 0] ** 2])
    mt = mogp_tpu_torch.MultiOutputGP(x, y, kernel=KERNELS, standardize=[True, False, True, False],
                                      device="cpu")
    mt.fit(np.column_stack([rng.uniform(-1, 1, size=(4, 2)), rng.uniform(-0.5, 0.5, size=4)]))
    coords = rng.uniform(size=(300, 2))
    obs = [[41.0, 0.3, -24.5, 0.25], [0.5, 0.02, 0.1, 0.01]]
    disc = [0.2, 0.0, 0.05, 0.0]

    preds = [em.predict(coords) for em in mt.emulators]
    mu, var = np.array([p.mean for p in preds]), np.array([p.unc for p in preds])
    I_all = np.abs(np.array(obs[0])[:, None] - mu) / np.sqrt(
        var + np.array(disc)[:, None] + np.array(obs[1])[:, None])
    I_ref = np.sort(I_all, axis=0)[-1 - rank]

    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 10**12)
    I_host = mogp_tpu_torch.HistoryMatching(gp=mt, obs=obs, coords=coords).get_implausibility(
        disc, rank)
    monkeypatch.setattr(thm, "_DEVICE_SWEEP_MIN_COORDS", 1)
    hm = mogp_tpu_torch.HistoryMatching(gp=mt, obs=obs, coords=coords)
    assert hm._device_sweep_applies()
    I_dev = hm.get_implausibility(disc, rank)
    assert_allclose(I_host, I_ref, rtol=1e-12)
    assert_allclose(I_dev, I_ref, rtol=1e-12)
