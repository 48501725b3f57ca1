"""Several processes (``init_distributed``) on the CPU, without hardware.

Port of ``tests/test_distributed.py``.  Two worker processes, which import
``mogp_tpu_torch`` and never ``jax``, join through
``mogp_tpu_torch.parallel.init_distributed`` on localhost (gloo); process 0
is given its arguments, process 1 reads torchrun's environment.  Each
takes 4 CPU entries of ``auto_mesh(8, device="cpu")``, the global mesh of
8, and runs the JAX test's problem through the sharded MAP fit; then 5
outputs over the 8 shards (three of them empty, the race on), a group of
one output that takes the rescue path, ``predict``, ``sample_MOGP_MCMC``
(which runs across processes in ``mogp_tpu`` too) and every other
``mesh=`` path, which must refuse the mesh.  Every process's results equal
the same runs in one process, over an 8-entry CPU mesh and unsharded, bit
for bit (a lane's arithmetic does not depend on its batch on the CPU),
and the NLPs equal ``mogp_tpu``'s ``sharded_fit_mogp`` on the 8 virtual CPU
devices of ``tests/conftest.py`` within the JAX test's ``rtol`` 1e-6.  A
worker that fails makes the run fail within seconds, not hang.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.parallel import auto_mesh as jax_mesh  # noqa: E402
from mogp_tpu.parallel.sharded import sharded_fit_mogp as jax_sharded_fit  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.parallel import auto_mesh, init_distributed  # noqa: E402
from mogp_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mogp_tpu_torch.tools.workers import WorkersFailed, run_workers  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240
REFUSING = ["HistoryMatching", "sample_GP_MCMC", "smc_history_match", "DeviceMICEDesign",
            "sharded_predict", "sharded_predict_mogp"]

# The problems, shared by the workers (exec'd there) and this process.
_PROBLEMS = r'''
import numpy as np

KERNELS = ["SquaredExponential"] * 4 + ["Matern52"]


def jax_test_problem():
    """tests/test_distributed.py's problem."""
    rng = np.random.RandomState(0)
    x = rng.uniform(size=(24, 3))
    w = rng.randn(8, 3)
    return x, np.sin(x @ w.T).T


def queries():
    return np.random.RandomState(3).uniform(size=(37, 3))


def fit_a(pkg, mesh):
    """The JAX test's fit: 8 outputs, n_tries=2, maxiter=25."""
    x, y = jax_test_problem()
    mgp = pkg.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    np.random.seed(1)
    return pkg.fit_GP_MAP(mgp, n_tries=2, maxiter=25, mesh=mesh)


def fit_b(pkg, mesh):
    """5 outputs over 8 shards, with the race (two stages)."""
    x, y = jax_test_problem()
    mgp = pkg.MultiOutputGP(x, y[:5], nugget="adaptive", device="cpu")
    np.random.seed(2)
    return pkg.fit_GP_MAP(mgp, n_tries=4, maxiter=20, mesh=mesh)


def fit_c(pkg, mesh):
    """Two signature groups, one of a single output, where every restart
    fails on the one-rung ladder: both groups take the rescue."""
    x, y = jax_test_problem()
    mgp = pkg.MultiOutputGP(x, y[:5], kernel=list(KERNELS), nugget="adaptive", device="cpu")
    np.random.seed(3)
    return pkg.fit_GP_MAP(mgp, n_tries=4, maxiter=20, mesh=mesh)


def single_rung_fails(tchol):
    """Make every factor of the one-rung trajectory ladder fail, as
    near-duplicate inputs can in float32; returns the undo."""
    real = tchol.jit_cholesky

    def jit_cholesky(A, *args, sparse_ladder=False, **kw):
        F, jitter = real(A, *args, sparse_ladder=sparse_ladder, **kw)
        if sparse_ladder == "single":
            return tchol.ChoFactor(F.L * float("nan")), jitter * float("nan")
        return F, jitter

    tchol.jit_cholesky = jit_cholesky
    return lambda: setattr(tchol, "jit_cholesky", real)


def mcmc(pkg, mgp, mesh):
    return pkg.sample_MOGP_MCMC(mgp, n_samples=5, n_warmup=5, n_chains=2, max_depth=4,
                                mesh=mesh)


def thetas(mgp):
    return np.stack([np.full(mgp.n_params, np.nan) if em.theta.get_data() is None
                     else em.theta.get_data() for em in mgp.emulators])


def nlps(mgp):
    return np.array([float(em.logposterior(em.theta.get_data())) for em in mgp.emulators])
'''

_WORKER = r'''
import json, os, sys

pid, port, out_dir, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
root = sys.argv[5]
sys.path.insert(0, root)
import numpy as np
import torch

torch.set_num_threads(2)
import mogp_tpu_torch as pkg
from mogp_tpu_torch.models import fitting
from mogp_tpu_torch.ops import cholesky as tchol
from mogp_tpu_torch.parallel import auto_mesh, init_distributed, mesh as pmesh

exec(open(os.path.join(out_dir, "problems.py")).read())
report = {"before": [pmesh.process_count(), pmesh.process_index()]}
if pid == 0:
    init_distributed("localhost:" + port, 2, 0)
else:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2", RANK="1")
    init_distributed()
report["after"] = [pmesh.process_count(), pmesh.process_index()]
mesh = auto_mesh(8, device="cpu")
report["processes"] = mesh.processes

if mode == "raise_in_shard":
    real = fitting._minimize_outputs

    def minimize(ems, *a):
        if pmesh.process_index() == 1:
            raise ValueError("shard of process 1 fails")
        return real(ems, *a)

    fitting._minimize_outputs = minimize
if mode == "raise_before_fit" and pid == 1:
    raise ValueError("process 1 fails before the fit")

a = fit_a(pkg, mesh)
if mode != "main":
    sys.exit(0)
b = fit_b(pkg, mesh)
b_phases = [k for k, _ in fitting.last_phase_times]
undo = single_rung_fails(tchol)
c = fit_c(pkg, mesh)
undo()
report["c_phases"] = [k for k, _ in fitting.last_phase_times]
report["b_phases"] = b_phases
mu, var, _ = a.predict(queries())
samples = np.stack([r.samples for r in mcmc(pkg, a, mesh)])

x, y = jax_test_problem()
q = queries()
gp0 = a.emulators[0]
calls = {
    "HistoryMatching": lambda: pkg.HistoryMatching(gp=a, obs=[np.zeros(8), np.ones(8)],
                                                   coords=q, mesh=mesh),
    "sample_GP_MCMC": lambda: pkg.sample_GP_MCMC(gp0, n_samples=2, n_warmup=2, n_chains=8,
                                                 mesh=mesh),
    "smc_history_match": lambda: pkg.smc_history_match(a, obs=[np.zeros(8), np.ones(8)],
                                                       bounds=[[0, 1]] * 3, n_particles=16,
                                                       mesh=mesh),
    "DeviceMICEDesign": lambda: pkg.DeviceMICEDesign(
        pkg.LatinHypercubeDesign([(0.0, 1.0), (0.0, 1.0)]), lambda z: z[0], n_samples=2,
        n_init=6, n_cand=16, device="cpu", mesh=mesh),
    "sharded_predict": lambda: pkg.parallel.sharded_predict(gp0, q, mesh=mesh),
    "sharded_predict_mogp": lambda: pkg.parallel.sharded_predict_mogp(a, q, mesh=mesh),
}
refusals = {}
for name, call in calls.items():
    try:
        call()
        refusals[name] = None
    except Exception as exc:
        refusals[name] = [type(exc).__name__, str(exc)]
report["refusals"] = refusals
report["gathers"] = len(pmesh.last_gathers)
report["imports_jax"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "mogp_tpu"))
json.dump(report, open(os.path.join(out_dir, "report{}.json".format(pid)), "w"))
np.savez(os.path.join(out_dir, "result{}.npz".format(pid)), a=thetas(a), a_nlp=nlps(a),
         b=thetas(b), c=thetas(c), mu=mu, var=var, samples=samples)
'''

ns = {}
exec(_PROBLEMS, ns)


def _launch(tmp_path, mode):
    (tmp_path / "problems.py").write_text(_PROBLEMS)
    (tmp_path / "worker.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    return run_workers(
        lambda port: [[sys.executable, str(tmp_path / "worker.py"), str(pid), str(port),
                       str(tmp_path), mode, ROOT] for pid in range(2)],
        DEADLINE, env=env, cwd=str(tmp_path))


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    _launch(out, "main")
    reports = [json.load(open(out / "report{}.json".format(p))) for p in range(2)]
    results = [dict(np.load(out / "result{}.npz".format(p))) for p in range(2)]
    return reports, results


@pytest.fixture(scope="module")
def one_process():
    """The same runs in this process: over an 8-entry CPU mesh and
    unsharded."""
    out = {}
    for tag, mesh in (("mesh", auto_mesh(8, device="cpu")), ("whole", None)):
        a = ns["fit_a"](mogp_tpu_torch, mesh)
        b = ns["fit_b"](mogp_tpu_torch, mesh)
        undo = ns["single_rung_fails"](tchol)
        try:
            c = ns["fit_c"](mogp_tpu_torch, mesh)
        finally:
            undo()
        mu, var, _ = a.predict(ns["queries"]())
        samples = np.stack([r.samples for r in ns["mcmc"](mogp_tpu_torch, a, mesh)])
        out[tag] = dict(a=ns["thetas"](a), a_nlp=ns["nlps"](a), b=ns["thetas"](b),
                        c=ns["thetas"](c), mu=mu, var=var, samples=samples)
    return out


def test_processes_join_and_the_mesh_spans_them(workers):
    reports, _ = workers
    for pid, rep in enumerate(reports):
        assert rep["before"] == [1, 0]
        assert rep["after"] == [2, pid]
        assert rep["processes"] == [0] * 4 + [1] * 4
        assert rep["imports_jax"] == []


def test_both_processes_hold_the_same_whole_fit(workers):
    _, (r0, r1) = workers
    for key in ("a", "a_nlp", "b", "c", "mu", "var", "samples"):
        assert np.array_equal(r0[key], r1[key], equal_nan=True), key
    assert np.isfinite(r0["a"]).all() and r0["a"].shape == (8, 4)


@pytest.mark.parametrize("tag", ["mesh", "whole"])
@pytest.mark.parametrize("key", ["a", "a_nlp", "b", "c", "mu", "var", "samples"])
def test_processes_equal_one_process(workers, one_process, tag, key):
    """Every process's fit, prediction and chains equal one process's over
    the 8-entry CPU mesh and unsharded, bit for bit."""
    _, (r0, _) = workers
    assert np.array_equal(r0[key], one_process[tag][key], equal_nan=True)


def test_nlps_match_mogp_tpu_sharded_fit(workers):
    """tests/test_distributed.py's check: rtol 1e-6 against mogp_tpu's
    sharded fit of the same seeded problem (8 virtual CPU devices)."""
    _, (r0, _) = workers
    x, y = ns["jax_test_problem"]()
    mgp = mogp_tpu.MultiOutputGP(x, y, nugget="adaptive")
    np.random.seed(1)
    mgp = jax_sharded_fit(mgp, n_tries=2, mesh=jax_mesh(axis_names=("outputs",)), maxiter=25)
    local = np.array([float(em.logposterior(em.theta.get_data())) for em in mgp.emulators])
    np.testing.assert_allclose(r0["a_nlp"], local, rtol=1e-6)


def test_race_and_rescue_gather_alike(workers):
    """The race's two stages, and the rescue of both groups (one of a
    single output, over 8 shards), ran in every process."""
    reports, (r0, _) = workers
    for rep in reports:
        assert rep["b_phases"] == ["stage0", "stage1", "refit"]
        assert rep["c_phases"] == ["stage0", "stage1", "rescue", "refit",
                                   "stage0", "stage1", "rescue", "refit"]
        assert rep["gathers"] > 0
    assert np.isfinite(r0["b"]).all() and np.isfinite(r0["c"]).all()


@pytest.mark.parametrize("path", REFUSING)
def test_other_mesh_paths_refuse_a_mesh_across_processes(workers, path):
    reports, _ = workers
    for rep in reports:
        kind, message = rep["refusals"][path]
        assert kind == "RuntimeError"
        assert "spans 2 processes" in message and "MAP fit" in message


@pytest.mark.parametrize("mode", ["raise_in_shard", "raise_before_fit"])
def test_a_failing_worker_fails_the_run_within_seconds(tmp_path, mode):
    """A shard that raises is raised in both processes, through the gather;
    a process that raises before the fit leaves its peer in a gather, and
    the launcher kills the peer instead of waiting for the collective's
    timeout."""
    t0 = time.monotonic()
    with pytest.raises(WorkersFailed) as err:
        _launch(tmp_path, mode)
    assert time.monotonic() - t0 < 60
    text = str(err.value)
    if mode == "raise_in_shard":
        assert [rc for rc, _ in err.value.outputs if rc is not None]
        assert "shard of process 1 fails" in text
    else:
        assert "process 1 fails before the fit" in text


# -- init_distributed's arguments, in this process ----------------------------------

def _no_torchrun_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def test_init_distributed_without_arguments_names_what_is_missing(monkeypatch):
    _no_torchrun_env(monkeypatch)
    with pytest.raises(ValueError, match="coordinator_address, num_processes, process_id"):
        init_distributed()
    with pytest.raises(ValueError, match="process_id"):
        init_distributed("localhost:1234", 2)
    with pytest.raises(ValueError, match="not in 0 ... 1"):
        init_distributed("localhost:1234", 2, 2)
    with pytest.raises(ValueError, match="host:port"):
        init_distributed("localhost", 2, 0)
    assert pmesh.process_count() == 1 and pmesh.process_index() == 0


@pytest.fixture
def fake_group(monkeypatch):
    """``torch.distributed``'s group replaced by a recorder: the arguments
    ``init_distributed`` passes, and every process on the CPU."""
    import torch.distributed as dist

    calls = {}

    def init_process_group(backend, **kw):
        calls.update(kw, backend=backend)

    def all_gather_object(out, obj):
        out[:] = [obj] * len(out)

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    monkeypatch.setattr(pmesh, "_world", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_torchrun_env(monkeypatch)
    return calls


def test_init_distributed_reads_torchruns_environment(fake_group, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    init_distributed()
    assert fake_group["init_method"] == "tcp://10.1.2.3:29500"
    assert fake_group["world_size"] == 4 and fake_group["rank"] == 3
    assert fake_group["backend"] == "gloo"
    assert 0 < fake_group["timeout"].total_seconds() < float("inf")
    assert pmesh.process_count() == 4 and pmesh.process_index() == 3


def test_init_distributed_arguments_and_the_cpu_mesh(fake_group, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "9")  # an argument wins over the environment
    init_distributed("[::1]:7000", 2, 1)
    assert fake_group["init_method"] == "tcp://[::1]:7000"
    assert (fake_group["world_size"], fake_group["rank"]) == (2, 1)
    assert pmesh.process_count() == 2 and pmesh.process_index() == 1
    mesh = auto_mesh(8, device="cpu")
    assert mesh.processes == [0] * 4 + [1] * 4 and mesh.spans_processes
    assert auto_mesh(device="cpu").processes == [0, 1]
    with pytest.raises(ValueError, match="2 processes"):
        auto_mesh(3, device="cpu")
    with pytest.raises(RuntimeError, match="spans 2 processes"):
        pmesh.check_mesh(mesh)
    assert pmesh.check_mesh(mesh, across_processes=True) is mesh
    # this process runs its own shards only
    assert pmesh.DeviceMesh(["cpu"] * 2, processes=[1, 1]).threaded is False
    with pytest.raises(ValueError, match="processes"):
        pmesh.DeviceMesh(["cpu"] * 2, processes=[0, 2])
