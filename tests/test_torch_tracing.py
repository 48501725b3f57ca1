"""The program's recorder (``mogp_tpu_torch/utils/metrics.py``): spans and
counters at the boundaries of its layers, on the CPU.

Off (no profiler, no ``recording()``) a fit records nothing and its own
clocks read as before; under ``torch.profiler`` or ``recording()`` every
span of a call hangs from one root and shares its request, the span names
reach the profiler's trace, and the counters equal what a wrapper around
the counted function sees.
"""

import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import fitting  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched, cholesky_blocked  # noqa: E402
from mogp_tpu_torch.parallel import DeviceMesh, auto_mesh  # noqa: E402
from mogp_tpu_torch.uq import history_matching as thm  # noqa: E402
from mogp_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(2)

_rng = np.random.RandomState(11)
X = _rng.rand(20, 2)
Y = np.stack([np.sin(3 * X[:, 0]) + X[:, 1], np.cos(2 * X[:, 1]) * X[:, 0],
              X[:, 0] - X[:, 1]]) + 0.1 * _rng.randn(3, 20)
FIT = dict(n_tries=4, maxiter=20)

FIT_PHASES = {"fitting.stage", "fitting.rescue", "fitting.refit"}


@pytest.fixture(autouse=True)
def empty_recorder():
    metrics.clear()
    yield
    metrics.clear()


def _mogp_fit(seed=0, **kw):
    np.random.seed(seed)
    return mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu"),
                                     **dict(FIT, **kw))


def _single_fit(seed=0, **kw):
    np.random.seed(seed)
    return mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.GaussianProcess(X, Y[0], device="cpu"),
                                     **dict(FIT, **kw))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(spans):
    """``{id: span}`` and each span's parent name (``None`` for a root)."""
    by_id = {s.id: s for s in spans}
    return by_id, Counter((s.name, by_id[s.parent].name if s.parent else None) for s in spans)


def test_off_records_nothing_and_the_fit_clocks_as_before():
    cholesky_batched.launches = 0
    for v in cholesky_blocked.launches:
        cholesky_blocked.launches[v] = 0
    assert not metrics.enabled()
    _mogp_fit()
    assert metrics.spans() == [] and metrics.counters() == {}
    assert metrics.recorder.report().splitlines()[1:] == []
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "stage1", "refit"]
    assert all(s > 0.0 for _, s in fitting.last_phase_times)
    # the CPU runs the kernels' plain versions: no launch is counted
    assert cholesky_batched.launches == 0
    assert sum(cholesky_blocked.launches.values()) == 0


@pytest.mark.parametrize("fit", [_mogp_fit, _single_fit], ids=["mogp", "single"])
def test_profiled_fit_records_its_spans_under_one_root(fit):
    _, prof = _profiled(fit)
    spans = metrics.spans()
    by_id, edges = _tree(spans)
    root = "fitting.fit_GP_MAP"
    assert edges[(root, None)] == 1
    assert edges[("fitting.starts", root)] == 1
    assert edges[("fitting.stage", root)] == 2     # the race: two stages
    assert edges[("fitting.refit", root)] == 1
    assert edges[("lbfgs.sync", "fitting.stage")] > 0
    assert edges[("gp.nlp", "fitting.stage")] == edges[("lbfgs.grad", "fitting.stage")] > 0
    assert set(n for n, _ in edges) == {root, "fitting.starts", "fitting.stage",
                                        "fitting.refit", "lbfgs.sync", "gp.nlp", "lbfgs.grad"}
    assert len({s.request for s in spans}) == 1
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent is not None:   # a child lies inside its parent
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.attrs["stage"] for s in spans if s.name == "fitting.stage"] == [0, 1]
    # each span opened a record_function: the names reach the profiler's trace
    assert {s.name for s in spans} <= {e.name for e in prof.events()}
    # the phase clock is written from the phase spans; the restart draws
    # count in the first stage's entry
    phases = [s.seconds for s in spans if s.name in FIT_PHASES]
    phases[0] += sum(s.seconds for s in spans if s.name == "fitting.starts")
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "stage1", "refit"]
    assert [v for _, v in fitting.last_phase_times] == pytest.approx(phases, rel=0, abs=1e-9)


def test_each_call_opens_its_own_request():
    with metrics.recording():
        _mogp_fit(0)
        _single_fit(1)
    roots = [s for s in metrics.spans() if s.parent is None]
    assert [s.name for s in roots] == ["fitting.fit_GP_MAP"] * 2
    assert len({s.request for s in metrics.spans()}) == 2
    for r in roots:
        assert {s.request for s in metrics.spans() if r.start_ns <= s.start_ns
                and s.end_ns <= r.end_ns} == {r.request}


def test_lane_counter_equals_the_lanes_gp_nlp_sees(monkeypatch):
    seen = []
    real = fitting.gp_nlp

    def counting(raw, *args, **kwargs):
        seen.append(raw.shape[0])
        return real(raw, *args, **kwargs)

    monkeypatch.setattr(fitting, "gp_nlp", counting)
    _profiled(_mogp_fit)
    assert metrics.counters()["gp.nlp_lanes"] == sum(seen) > 0
    # the race's first stage evaluates every (output, restart) lane at once
    assert seen[0] == len(Y) * FIT["n_tries"]


def test_matrix_counter_equals_the_batches_factored(monkeypatch):
    batches = []
    real = tchol._factor

    def counting(A):
        if A.shape[-1]:
            batches.append(A.shape[:-2].numel())
        return real(A)

    monkeypatch.setattr(tchol, "_factor", counting)
    _profiled(_mogp_fit)
    c = metrics.counters()
    assert c["chol.matrices"] == sum(batches) > 0
    # one factor a lane on the optimizer's one-rung ladder, six a winner in the refit
    assert c["chol.matrices"] == c["gp.nlp_lanes"] + 6 * len(Y)


def test_recording_without_a_profiler():
    assert not metrics.enabled()
    with metrics.recording():
        assert metrics.enabled()
        with metrics.span("outer", n=3):
            with metrics.span("inner"):
                metrics.count("things", 2)
            metrics.count("things", 5)
    assert not metrics.enabled()
    outer, inner = sorted(metrics.spans(), key=lambda s: s.start_ns)
    assert (outer.name, outer.parent, outer.attrs) == ("outer", None, {"n": 3})
    assert (inner.name, inner.parent, inner.request) == ("inner", outer.id, outer.request)
    assert metrics.counters() == {"things": 7}
    assert metrics.recorder.counts == {"outer": 1, "inner": 1}
    with metrics.span("ignored"):
        metrics.count("things", 1)
    assert len(metrics.spans()) == 2 and metrics.counters() == {"things": 7}
    metrics.clear()
    assert metrics.spans() == [] and metrics.counters() == {} and metrics.recorder.totals == {}


def test_timed_span_times_whether_on_or_off():
    with metrics.timed_span("x") as s:
        pass
    assert s.seconds >= 0.0 and metrics.spans() == []
    with metrics.recording(), metrics.timed_span("x") as s:
        pass
    assert [r.seconds for r in metrics.spans()] == [s.seconds]


def test_counter_is_exact_across_threads():
    # a lost update under contention would leave the count short
    def add():
        for _ in range(2000):
            metrics.count("n", 1)

    with metrics.recording():
        threads = [threading.Thread(target=add) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert metrics.counters() == {"n": 16000}


def test_history_matching_wave_records_its_spans():
    np.random.seed(3)
    mgp = mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu")
    mgp.fit(np.zeros((len(Y), 3)))
    coords = np.random.rand(thm._DEVICE_SWEEP_MIN_COORDS + 72, 2)
    hm = mogp_tpu_torch.HistoryMatching(gp=mgp, obs=[Y[:, 0], np.full(len(Y), 0.01)],
                                        coords=coords)
    assert hm._device_sweep_applies()
    I, prof = _profiled(lambda: hm.get_implausibility(rank=1))
    assert I.shape == (len(coords),)
    _, edges = _tree(metrics.spans())
    root = "hm.get_implausibility"
    assert edges[(root, None)] == 1
    assert edges[("hm.inputs", root)] >= 2      # the pool, then the group's query tensor
    assert edges[("hm.results", root)] == 1     # one emulator group
    assert edges[("hm.rank_select", root)] == 1
    assert len({s.request for s in metrics.spans()}) == 1
    assert [s.attrs for s in metrics.spans() if s.name == root] == [{"points": len(coords)}]
    assert {s.name for s in metrics.spans()} <= {e.name for e in prof.events()}


def test_spans_on_map_shards_threads_name_their_caller(monkeypatch):
    # the shards of a mesh of distinct cards run on threads of their own
    monkeypatch.setattr(DeviceMesh, "threaded", property(lambda self: True))
    mesh = auto_mesh(3, device="cpu")
    np.random.seed(0)
    mgp = mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu")
    main = threading.get_ident()
    threads = set()
    real = fitting._minimize

    def where(*args, **kwargs):
        threads.add(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(fitting, "_minimize", where)
    _profiled(lambda: mogp_tpu_torch.fit_GP_MAP(mgp, mesh=mesh, **FIT))
    assert threads and main not in threads
    by_id, edges = _tree(metrics.spans())
    # each stage's three shards, each on a thread, enqueue under the stage
    assert edges[("gp.nlp", "fitting.stage")] > 0
    assert edges[("lbfgs.sync", "fitting.stage")] > 0
    assert {p for (n, p) in edges if n in ("gp.nlp", "lbfgs.grad", "lbfgs.sync")} == {
        "fitting.stage"}
    assert len({s.request for s in metrics.spans()}) == 1
    # the threads' recording ends with them
    assert not metrics.enabled()


def test_threads_outside_a_traced_mesh_fit_record_nothing(monkeypatch):
    # while a shard's thread records for its traced caller, an unrelated
    # fit on another thread, under no profiler, records no span or count
    monkeypatch.setattr(DeviceMesh, "threaded", property(lambda self: True))
    mesh = auto_mesh(3, device="cpu")
    np.random.seed(0)
    mgp = mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu")
    main = threading.get_ident()
    lanes, other = [], []
    once = threading.Lock()   # the first shard to take it starts the unrelated fit
    real_nlp, real_minimize = fitting.gp_nlp, fitting._minimize

    def nlp(raw, *args, **kwargs):
        lanes.append((threading.current_thread().name, raw.shape[0]))
        return real_nlp(raw, *args, **kwargs)

    def unrelated():
        other.append(metrics.enabled())
        _single_fit(5)

    def minimize(*args, **kwargs):
        if threading.get_ident() != main and once.acquire(blocking=False):
            t = threading.Thread(target=unrelated, name="unrelated")
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        return real_minimize(*args, **kwargs)

    monkeypatch.setattr(fitting, "gp_nlp", nlp)
    monkeypatch.setattr(fitting, "_minimize", minimize)
    _profiled(lambda: mogp_tpu_torch.fit_GP_MAP(mgp, mesh=mesh, **FIT))
    assert other == [False]
    spans = metrics.spans()
    assert [s.name for s in spans if s.parent is None] == ["fitting.fit_GP_MAP"]
    assert len({s.request for s in spans}) == 1
    mine = sum(n for t, n in lanes if t != "unrelated")
    assert mine < sum(n for _, n in lanes)
    assert metrics.counters()["gp.nlp_lanes"] == mine
    assert not metrics.enabled()


def test_single_gp_writes_the_phase_clock():
    _single_fit()
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "stage1", "refit"]
    _single_fit(race=False)
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "refit"]


def test_single_gp_rescue_writes_the_phase_clock(monkeypatch):
    real = tchol.jit_cholesky

    def jit_cholesky(A, *args, sparse_ladder=False, **kw):
        F, jitter = real(A, *args, sparse_ladder=sparse_ladder, **kw)
        if sparse_ladder == "single":   # every point fails on the one-rung ladder
            return tchol.ChoFactor(F.L * torch.nan), jitter * torch.nan
        return F, jitter

    monkeypatch.setattr(tchol, "jit_cholesky", jit_cholesky)
    with metrics.recording():
        gp = _single_fit(4)
    assert np.isfinite(gp.current_logpost)
    assert [k for k, _ in fitting.last_phase_times] == ["stage0", "stage1", "rescue", "refit"]
    _, edges = _tree(metrics.spans())
    assert edges[("fitting.rescue", "fitting.fit_GP_MAP")] == 1
    # the rescue's schedule runs inside it, not as stages of their own
    assert edges[("fitting.stage", "fitting.fit_GP_MAP")] == 2
    assert edges[("gp.nlp", "fitting.rescue")] > 0
