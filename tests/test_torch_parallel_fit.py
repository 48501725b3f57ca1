"""The port's multi-device layer (``parallel/``): the mesh, the sharded MAP
fit and the sharded prediction, on ``device="cpu"`` meshes of 4 and 8.

Port of ``tests/test_parallel.py`` (the fit and prediction half; the UQ
half is ``tests/test_torch_parallel_uq.py``), with ``mogp_tpu``'s
tolerances: theta ``rtol`` 1e-6 / ``atol`` 1e-7, predictions ``rtol``
1e-9.  Within the port a sharded fit equals the unsharded one bit for bit
(a lane's arithmetic does not depend on its batch on the CPU); the
sharded prediction splits the query axis, whose matrix products the CPU
blocks by their size, so it is held to the tolerance.  A seeded sharded
fit is also held against ``mogp_tpu``'s own mesh path (8 virtual CPU
devices, ``tests/conftest.py``) with ``tests/test_torch_fit_map.py``'s
tolerances.  On a CPU mesh the shards run one after another; the threads
of a mesh of several cards are driven here by marking the mesh threaded.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.parallel import auto_mesh as jax_mesh  # noqa: E402
from mogp_tpu.parallel import sharded_fit_mogp as jax_sharded_fit  # noqa: E402
from mogp_tpu_torch import GaussianProcess, MultiOutputGP, fit_GP_MAP  # noqa: E402
from mogp_tpu_torch.ops import _build  # noqa: E402
from mogp_tpu_torch.ops import hmc  # noqa: E402
from mogp_tpu_torch.parallel import (  # noqa: E402
    DeviceMesh,
    auto_mesh,
    replicate,
    shard_leading,
    sharded_fit_mogp,
    sharded_predict,
    sharded_predict_mogp,
)
from mogp_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mogp_tpu_torch.parallel import sharded as psh  # noqa: E402

torch.set_num_threads(2)

rng = np.random.RandomState(0)
X = rng.rand(16, 3)
YS = np.stack([np.sin((k + 1) * X[:, 0]) + X[:, 1] for k in range(8)])
THETA_RTOL, THETA_ATOL = 1e-6, 1e-7


def cpu_mesh(n, **kw):
    return auto_mesh(n, device="cpu", **kw)


def _thetas(mgp):
    return np.stack([em.theta.get_data() for em in mgp.emulators])


@pytest.fixture
def threaded(monkeypatch):
    """Mark every mesh threaded, as a mesh of distinct cards is: the shards
    then run on threads of their own."""
    monkeypatch.setattr(DeviceMesh, "threaded", property(lambda self: True))


# -- the mesh ------------------------------------------------------------------

def test_auto_mesh():
    mesh = cpu_mesh(4)
    assert mesh.shape["outputs"] == 4 and mesh.shape[mesh.axis_names[0]] == 4
    assert mesh.devices == [torch.device("cpu")] * 4 and not mesh.threaded
    mesh2 = cpu_mesh(8, axis_names=("outputs", "data"), shape=(4, 2))
    assert mesh2.shape == {"outputs": 4, "data": 2}
    assert len(mesh2.shard_devices()) == 4 and len(mesh2.shard_devices("data")) == 2
    assert cpu_mesh(None).shape == {"outputs": 1}


def test_auto_mesh_on_cuda_never_repeats_a_card():
    if torch.cuda.is_available():
        mesh = auto_mesh()
        assert len(set(mesh.devices)) == len(mesh.devices) == torch.cuda.device_count()
        with pytest.raises(ValueError, match="CUDA devices"):
            auto_mesh(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            auto_mesh()


def test_device_mesh_checks_and_threading_rule():
    with pytest.raises(ValueError):
        DeviceMesh([])
    with pytest.raises(ValueError, match="shape"):
        DeviceMesh(["cpu"] * 4, shape=(3,))
    one_card = DeviceMesh([torch.device("cuda:0")] * 4)
    assert one_card.shape == {"outputs": 4} and not one_card.threaded
    assert DeviceMesh(["cuda:0", "cuda:1"]).threaded
    assert not DeviceMesh(["cuda:0"]).threaded
    # a mesh of this process alone spans no processes, and runs every shard
    assert one_card.processes is None and not one_card.spans_processes
    assert DeviceMesh(["cuda:0", "cuda:1"], processes=[0, 0]).threaded


def test_shard_leading_and_replicate():
    mesh = cpu_mesh(4)
    tree = {"a": torch.arange(8.0), "b": (torch.ones(3), torch.zeros(4, 2)), "c": 5}
    pieces = shard_leading(tree, mesh)
    assert len(pieces) == 4
    assert [p["a"].tolist() for p in pieces] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert all(p["b"][0].shape == (3,) for p in pieces)        # 3 % 4: replicated
    assert [p["b"][1].shape for p in pieces] == [(1, 2)] * 4
    assert all(p["c"] == 5 for p in pieces)
    reps = replicate(tree, mesh)
    assert len(reps) == 4 and all(r["a"] is tree["a"] for r in reps)


def test_split_rows_and_map_shards_order(threaded):
    assert pmesh.split_rows(10, 4) == [slice(0, 3), slice(3, 6), slice(6, 8), slice(8, 10)]
    assert pmesh.split_rows(2, 4) == [slice(0, 1), slice(1, 2)]
    mesh = cpu_mesh(4)
    assert mesh.threaded
    # every shard waits for all four: they run at once, on threads
    barrier = threading.Barrier(4, timeout=30)
    names = pmesh.map_shards(mesh, lambda k, d: (k, barrier.wait() is not None,
                                                 threading.current_thread().name))
    assert [k for k, _, _ in names] == [0, 1, 2, 3]
    assert len({n for _, _, n in names}) == 4
    with torch.no_grad():
        grads = pmesh.map_shards(mesh, lambda k, d: torch.is_grad_enabled())
    assert grads == [False] * 4
    with pytest.raises(ZeroDivisionError):
        pmesh.map_shards(mesh, lambda k, d: 1 / (k - 2))


def test_launch_counters_are_exact_under_threads():
    """Every wrapper adds under one lock, and ``hmc.counters.add`` under
    its own: 16 threads x 2000 additions lose none."""
    from mogp_tpu_torch.ops import kernel_matrix as km

    def bump():
        global_km = km
        for _ in range(2000):
            with _build.count_lock:
                global_km.launches += 1
            hmc.counters.add(leapfrogs=1, useful=torch.tensor(1))

    before = km.launches
    hmc.counters.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert km.launches - before == 32000
    read = hmc.counters.read()
    assert read["leapfrogs"] == 32000 and read["useful_lane_leapfrogs"] == 32000
    hmc.counters.reset()


def test_recorded_here_counts_the_current_thread_only():
    from mogp_tpu_torch.ops import cholesky_batched as kb

    seen = []

    def other():
        seen.append(kb.recorded_here())
        kb._here.recorded = 7
        seen.append(kb.recorded_here())

    mine = kb.recorded_here()
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert seen == [0, 7] and kb.recorded_here() == mine


def test_mesh_must_be_a_device_mesh():
    mgp = MultiOutputGP(X, YS[:2], device="cpu")
    for bad in (object(), "cpu", [torch.device("cpu")]):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fit_GP_MAP(mgp, n_tries=1, mesh=bad)
        with pytest.raises(TypeError, match="DeviceMesh"):
            sharded_predict_mogp(mgp, X, mesh=bad)


# -- the sharded fit ---------------------------------------------------------------

@pytest.fixture(scope="module")
def local_fit():
    np.random.seed(1)
    return fit_GP_MAP(MultiOutputGP(X, YS, device="cpu"), n_tries=2, maxiter=30)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_fit_matches_local(local_fit, n_dev):
    np.random.seed(1)
    mgp = sharded_fit_mogp(MultiOutputGP(X, YS, device="cpu"), n_tries=2, mesh=cpu_mesh(n_dev),
                           maxiter=30)
    assert len(mgp.get_indices_fit()) == 8
    assert_allclose(_thetas(mgp), _thetas(local_fit), rtol=THETA_RTOL, atol=THETA_ATOL)
    # a lane does not depend on its batch: bit for bit
    assert np.array_equal(_thetas(mgp), _thetas(local_fit))
    for a, b in zip(mgp.emulators, local_fit.emulators):
        assert a.current_logpost == b.current_logpost
        assert a._artifacts.raw.device == torch.device("cpu")


def test_sharded_fit_on_threads_matches_local(local_fit, threaded):
    np.random.seed(1)
    mgp = fit_GP_MAP(MultiOutputGP(X, YS, device="cpu"), n_tries=2, maxiter=30,
                     mesh=cpu_mesh(4))
    assert np.array_equal(_thetas(mgp), _thetas(local_fit))


def test_sharded_fit_splits_whole_outputs(monkeypatch):
    """Each shard minimizes whole outputs (all their restarts), and the
    refit splits the winners the same way."""
    from mogp_tpu_torch.models import fitting

    calls = []
    minimize = fitting._minimize_outputs

    def spy(ems, starts, *a):
        calls.append(starts.shape)
        return minimize(ems, starts, *a)

    monkeypatch.setattr(fitting, "_minimize_outputs", spy)
    np.random.seed(1)
    fit_GP_MAP(MultiOutputGP(X, YS[:6], device="cpu"), n_tries=4, maxiter=20, race=False,
               mesh=cpu_mesh(4))
    assert calls == [(2, 4, 4), (2, 4, 4), (1, 4, 4), (1, 4, 4)]


def test_sharded_fit_heterogeneous_matches_local():
    kernels = ["SquaredExponential"] * 4 + ["Matern52"] * 4
    nuggets = ["adaptive"] * 4 + ["fit"] * 4
    np.random.seed(3)
    local = fit_GP_MAP(MultiOutputGP(X, YS, kernel=list(kernels), nugget=list(nuggets),
                                     device="cpu"), n_tries=2, maxiter=30)
    np.random.seed(3)
    shard = sharded_fit_mogp(MultiOutputGP(X, YS, kernel=list(kernels), nugget=list(nuggets),
                                           device="cpu"), n_tries=2, mesh=cpu_mesh(8), maxiter=30)
    assert len(shard.get_indices_fit()) == 8
    for a, b in zip(shard.emulators, local.emulators):
        assert_allclose(a.theta.get_data(), b.theta.get_data(), rtol=THETA_RTOL, atol=THETA_ATOL)


def test_sharded_fit_single_gp_warns_and_fits():
    np.random.seed(2)
    ref = fit_GP_MAP(GaussianProcess(X, YS[0], device="cpu"), n_tries=2)
    np.random.seed(2)
    with pytest.warns(UserWarning, match="mesh"):
        gp = fit_GP_MAP(GaussianProcess(X, YS[0], device="cpu"), n_tries=2, mesh=cpu_mesh(4))
    assert np.array_equal(gp.theta.get_data(), ref.theta.get_data())


# seeded noisy targets (tests/test_torch_fit_map.py's problem): the optima
# are well conditioned, so the two packages' winners agree to THETA_ATOL
_frng = np.random.RandomState(7)
XF = _frng.rand(25, 2) * 2
YF = np.stack([np.sin(3 * XF[:, 0]) + XF[:, 1] ** 2, np.cos(2 * XF[:, 1]) + XF[:, 0],
               XF[:, 0] * XF[:, 1], XF[:, 0] - XF[:, 1]]) + 0.3 * _frng.randn(4, 25)


def test_sharded_fit_matches_mogp_tpus_mesh_path():
    np.random.seed(5)
    ref = jax_sharded_fit(mogp_tpu.MultiOutputGP(XF, YF), n_tries=4, mesh=jax_mesh(4),
                          maxiter=20)
    np.random.seed(5)
    got = sharded_fit_mogp(MultiOutputGP(XF, YF, device="cpu"), n_tries=4, mesh=cpu_mesh(4),
                           maxiter=20)
    for et, ej in zip(got.emulators, ref.emulators):
        assert_allclose(et.theta.get_data(), ej.theta.get_data(), rtol=0, atol=1e-6)
        assert_allclose(et.current_logpost, ej.current_logpost, rtol=1e-8)


# -- the sharded prediction ---------------------------------------------------------

@pytest.fixture(scope="module")
def gp():
    np.random.seed(4)
    return fit_GP_MAP(GaussianProcess(X, YS[0], device="cpu"), n_tries=2)


def test_sharded_predict_matches_local(gp):
    testing = rng.rand(40, 3)
    ref = gp.predict(testing)
    mu, var = sharded_predict(gp, testing, mesh=cpu_mesh(8))
    assert mu.dtype == np.float64 and mu.shape == (40,)
    assert_allclose(mu, ref.mean, rtol=1e-9)
    assert_allclose(var, ref.unc, rtol=1e-7, atol=1e-12)
    mu2, var2 = sharded_predict(gp, testing, mesh=cpu_mesh(8), unc=False)
    assert var2 is None and np.array_equal(mu2, mu)


@pytest.mark.parametrize("n_query", [1, 7, 13])
def test_sharded_predict_odd_sizes(gp, n_query):
    testing = rng.rand(n_query, 3)
    mu, var = sharded_predict(gp, testing, mesh=cpu_mesh(8))
    ref = gp.predict(testing)
    assert_allclose(mu, ref.mean, rtol=1e-9)


def test_sharded_predict_super_chunks_and_standardize(gp):
    """Many super-chunks (max_batch_size), a standardized emulator."""
    np.random.seed(6)
    sgp = fit_GP_MAP(GaussianProcess(X, 10 + 3 * YS[1], standardize=True, device="cpu"),
                     n_tries=2)
    testing = rng.rand(1100, 3)
    for em in (gp, sgp):
        ref = em.predict(testing)
        mu, var = sharded_predict(em, testing, mesh=cpu_mesh(3), max_batch_size=256)
        assert_allclose(mu, ref.mean, rtol=1e-9)
        assert_allclose(var, ref.unc, rtol=1e-7, atol=1e-12)


def test_super_chunks_and_pad_rows():
    assert list(psh._super_chunks(37, 8, None)) == [(0, 37, 40)]
    assert list(psh._super_chunks(1100, 2, 256)) == [(0, 512, 512), (512, 1024, 512),
                                                     (1024, 1100, 512)]
    a = np.arange(6.0).reshape(3, 2)
    assert np.array_equal(psh._pad_rows(a, 5), np.array([[0, 1], [2, 3], [4, 5], [4, 5],
                                                         [4, 5]], dtype=float))
    assert psh._pad_rows(a, 3) is a


@pytest.fixture(scope="module")
def mgp():
    r = np.random.RandomState(21)
    x = r.uniform(size=(20, 2))
    y = np.stack([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1]), x[:, 0] * x[:, 1]])
    np.random.seed(8)
    return fit_GP_MAP(MultiOutputGP(x, y, nugget="adaptive", device="cpu"), n_tries=2,
                      maxiter=30)


def _mean_atol(m):
    """The rounding floor of a predictive mean ``m(x) + K*^T alpha``: an ulp
    of each ``K*`` entry moves it by ``eps * sum |alpha|``, and the CPU's
    products round ``K*`` by the query count (this problem's adaptive
    nuggets are 0 and ``|alpha|`` reaches 1.5e7, so a prediction of 37
    queries and one of 5 differ by 1.9e-9); ten times that, per output."""
    alpha = np.stack([np.abs(em._artifacts.Kinv_t_mean.numpy()).sum() for em in m.emulators])
    return 10 * np.finfo(np.float64).eps * alpha[:, None]


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_predict_mogp_matches_local(mgp, n_dev):
    testing = np.random.RandomState(22).uniform(size=(37, 2))   # not divisible by 8
    mesh = cpu_mesh(n_dev, axis_names=("data",))
    mu_s, var_s = sharded_predict_mogp(mgp, testing, mesh=mesh)
    assert mu_s.shape == (3, 37) and mu_s.dtype == np.float64
    # the split and the merge are exact: each shard's rows as predicted alone
    per = -(-37 // n_dev)
    split = [mgp.predict(psh._pad_rows(testing, per * n_dev)[k * per:(k + 1) * per])
             for k in range(n_dev)]
    assert np.array_equal(mu_s, np.concatenate([r.mean for r in split], axis=1)[:, :37])
    assert np.array_equal(var_s, np.concatenate([r.unc for r in split], axis=1)[:, :37])
    ref = mgp.predict(testing)
    assert np.all(np.abs(mu_s - ref.mean) <= 1e-9 * np.abs(ref.mean) + _mean_atol(mgp))
    assert_allclose(var_s, ref.unc, rtol=1e-8, atol=1e-12)


def test_sharded_predict_mogp_on_threads(mgp, threaded):
    testing = np.random.RandomState(23).uniform(size=(50, 2))
    mu_s, var_s = sharded_predict_mogp(mgp, testing, mesh=cpu_mesh(4))
    mu_l, var_l = sharded_predict_mogp(mgp, testing, mesh=DeviceMesh(["cpu"] * 4))
    assert np.array_equal(mu_s, mu_l) and np.array_equal(var_s, var_l)


def test_sharded_predict_mogp_unfit_rows(mgp):
    testing = np.random.RandomState(24).uniform(size=(9, 2))
    part = MultiOutputGP(mgp.inputs, mgp.targets, device="cpu")
    part.fit_emulator(0, mgp.emulators[0].theta.get_data())
    with pytest.raises(ValueError, match="not been fit"):
        sharded_predict_mogp(part, testing, mesh=cpu_mesh(4))
    mu, var = sharded_predict_mogp(part, testing, mesh=cpu_mesh(4), allow_not_fit=True)
    assert np.isnan(mu[1:]).all() and np.isnan(var[1:]).all()
    assert_allclose(mu[0], mgp.emulators[0].predict(testing).mean, rtol=1e-9)


def test_sharded_predict_mogp_heterogeneous_means():
    """Different mean formulas of equal width: each group gets its own
    design matrix."""
    r = np.random.RandomState(5)
    x = r.uniform(size=(30, 2))
    y0 = 4.0 * x[:, 0] + 0.05 * np.sin(6 * x[:, 1])
    y1 = 4.0 * x[:, 1] + 0.05 * np.sin(6 * x[:, 0])
    np.random.seed(7)
    m = fit_GP_MAP(MultiOutputGP(x, np.stack([y0, y1]), mean=["x[0]", "x[1]"],
                                 nugget="adaptive", device="cpu"), n_tries=2, maxiter=30)
    testing = r.uniform(size=(23, 2))
    mu_s, _ = sharded_predict_mogp(m, testing, mesh=cpu_mesh(8))
    for i in range(2):
        assert_allclose(mu_s[i], m.emulators[i].predict(testing).mean, rtol=1e-8, atol=1e-9)
