"""The lockstep L-BFGS from CUDA graphs (``ops/lbfgs.py``, ``ops/graphs.py``), on the CPU.

A CUDA graph cannot be captured here, so a stand-in takes
``graphs.capture``'s place: the same warm-ups, a "capture" that tallies the
counts as the real one does, and a "replay" that calls the segment again
into the same static buffers.  Driven so, the graphed runner must give what
the eager runner gives, bit for bit, and count what it counts; the choice
between them (``models/fitting.py::_graphed``) and the cache's bound are
checked as they are.  The card runs the real graphs (``chip_smoke.py``,
phase 4).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import fitting  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import cholesky_batched as kb  # noqa: E402
from mogp_tpu_torch.ops import graphs, lbfgs  # noqa: E402
from mogp_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("x", "fun", "grad", "n_iter", "converged")

# what K2's wrapper would do on the card: count a launch, or record it into
# the graph being captured, or nothing while a graph replays (the replay
# adds the recorded launches)
_k2 = threading.local()


def _k2_stand_in(A):
    mode = getattr(_k2, "mode", "eager")
    if A.numel() == 0:   # an empty factor launches nothing
        pass
    elif mode == "capture":
        kb._here.recorded = kb.recorded_here() + 1
    elif mode == "eager":
        kb.launches += 1
    return kb.cholesky_batched_plain(A)


class _Replay:
    """Stands in for a ``torch.cuda.CUDAGraph``: a replay runs the captured
    function again, on the same tensors, and records nothing itself."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        _k2.mode = "replay"
        try:
            with metrics.tally():
                self.fn()
        finally:
            _k2.mode = "eager"


_captures = []


def _capture_stand_in(fn, device):
    _captures.append(fn)
    for _ in range(graphs.WARMUPS):
        fn()
    before = kb.recorded_here()
    _k2.mode = "capture"
    try:
        with metrics.tally() as counts:
            out = fn()
    finally:
        _k2.mode = "eager"
    return graphs.Graph(_Replay(fn), kb.recorded_here() - before, counts), out


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _capture_stand_in)
    monkeypatch.setattr(tchol, "cholesky_batched", _k2_stand_in)
    lbfgs.clear_graphs()
    yield
    lbfgs.clear_graphs()
    metrics.clear()


def _graphed(fun, x0, maxiter, max_linesearch=2):
    """The graphed runner as ``lbfgs_minimize`` calls it on a card."""
    gtol, ftol = lbfgs._tolerances(x0.dtype)
    return lbfgs._run_graphed(fun, x0, maxiter, gtol, ftol, 10, max_linesearch, 1e-4)


def _kept(device=torch.device("cpu")):
    """The lanes of each lockstep cached on ``device``, oldest first."""
    return [key[1][0] for key in lbfgs._graph_cache[device]]


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    for field in FIELDS:
        torch.testing.assert_close(getattr(a, field), getattr(b, field), rtol=0, atol=0,
                                   equal_nan=True, msg=field)


def _rosen(x, args):
    (scale,) = args
    return torch.sum(scale * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, dim=-1)


def _quadratic(x, args):
    H, c = args
    return 0.5 * torch.einsum("lp,lpq,lq->l", x, H, x) - torch.sum(c * x, dim=-1)


def _quadratic_args(L, P, seed, dtype=torch.float64):
    rng = np.random.RandomState(seed)
    Q = rng.randn(L, P, P)
    H = Q @ np.transpose(Q, (0, 2, 1)) + 0.5 * np.eye(P)
    return (torch.as_tensor(H, dtype=dtype), torch.as_tensor(rng.randn(L, P), dtype=dtype))


@pytest.mark.parametrize("max_linesearch", [2, 5])
def test_rosenbrock_graphed_equals_eager(stand_in, max_linesearch):
    rng = np.random.RandomState(1)
    x0 = torch.as_tensor(rng.uniform(-2.0, 2.0, size=(6, 3)))
    x0[3, 0] = float("nan")   # a lane that stops at once
    args = (torch.tensor(100.0, dtype=torch.float64),)
    fun = lbfgs.Capturable(_rosen, args, "rosen", "rosen")
    eager = lbfgs.lbfgs_minimize(lambda x: _rosen(x, args), x0, maxiter=40,
                                 max_linesearch=max_linesearch)
    _same(_graphed(fun, x0, 40, max_linesearch), eager)
    assert len(set(eager.n_iter.tolist())) > 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_quadratic_graphed_equals_eager_and_replays_new_arguments(stand_in, dtype):
    x0 = torch.as_tensor(np.random.RandomState(0).randn(4, 5), dtype=dtype)
    for seed in (0, 1):   # the second call replays the first call's graphs
        args = _quadratic_args(4, 5, seed, dtype)
        fun = lbfgs.Capturable(_quadratic, args, "quadratic", "quadratic")
        eager = lbfgs.lbfgs_minimize(lambda x: _quadratic(x, args), x0, maxiter=60)
        _same(_graphed(fun, x0, 60), eager)
    assert len(lbfgs._entries()) == 1


def test_a_capturable_objective_on_the_cpu_runs_eagerly(monkeypatch):
    def refuse(fn, device):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(graphs, "capture", refuse)
    args = _quadratic_args(3, 4, 2)
    x0 = torch.zeros(3, 4, dtype=torch.float64)
    res = lbfgs.lbfgs_minimize(lbfgs.Capturable(_quadratic, args, "q", "q"), x0, maxiter=30)
    _same(res, lbfgs.lbfgs_minimize(lambda x: _quadratic(x, args), x0, maxiter=30))


def _fit_problem(seed, n_out=2, n=24):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = np.stack([np.sin(3.0 * x[:, 0]) + x[:, 1] + 0.1 * k for k in range(n_out)])
    return x, y


def _lanes(mgp, T, seed):
    data = tgp.cat_lanes([em._data for em in mgp.emulators])
    lanes = torch.arange(mgp.n_emulators).repeat_interleave(T)
    np.random.seed(seed)
    starts = np.concatenate([em.priors.sample_n(T) for em in mgp.emulators])
    return tgp.take_lanes(data, lanes), mgp.emulators[0]._tensor(starts)


@pytest.mark.parametrize("nugget", ["adaptive", "fit"])
def test_gp_objective_graphed_equals_eager(stand_in, nugget):
    x, y = _fit_problem(0)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget=nugget, device="cpu",
                                       dtype=torch.float32)
    data, starts = _lanes(mgp, 5, 0)
    em = mgp.emulators[0]
    fun = lbfgs.Capturable(
        lambda raw, d: tgp.gp_nlp(raw, d, em.kernel, nugget, sparse_ladder="single",
                                  progressive_ok=False),
        data, (em.kernel, nugget, "single"), "gp.nlp")
    eager = lbfgs.lbfgs_minimize(lambda raw: fun.fn(raw, data), starts, maxiter=25)
    _same(_graphed(fun, starts, 25), eager)


def _fit(mgp, seed):
    np.random.seed(seed)
    mogp_tpu_torch.fit_GP_MAP(mgp, n_tries=5, maxiter=30, refit=True)
    return np.array([em.theta.get_data() for em in mgp.emulators]), \
        np.array([em.current_logpost for em in mgp.emulators])


def test_whole_fit_through_the_graphed_runner_equals_the_eager_fit(stand_in, monkeypatch):
    x, y = _fit_problem(1, n_out=3)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    eager = [_fit(mgp, seed) for seed in (3, 4)]

    handed = []

    def graphed_minimize(fun, x0, maxiter, gtol, ftol):
        handed.append(type(fun))
        return _graphed(fun, x0, maxiter)

    monkeypatch.setattr(fitting, "_graphed", lambda *a: True)
    monkeypatch.setattr(fitting, "lbfgs_minimize", graphed_minimize)
    graphed = [_fit(mgp, seed) for seed in (3, 4)]
    assert handed and set(handed) == {lbfgs.Capturable}
    for (t_e, n_e), (t_g, n_g) in zip(eager, graphed):
        np.testing.assert_array_equal(t_g, t_e)
        np.testing.assert_array_equal(n_g, n_e)
    # one captured lockstep a race stage's shape: 3 x 5 lanes, then 3 x 2
    assert sorted(_kept()) == [6, 15]


@pytest.mark.parametrize("device_type,n,dtype,ladder,nugget,graphed", [
    ("cuda", 210, torch.float32, "single", "adaptive", True),
    ("cuda", 210, torch.float32, "single", "fit", True),
    ("cuda", 340, torch.float32, "single", "adaptive", True),
    ("cuda", 240, torch.float64, "single", "adaptive", True),
    ("cuda", 4096, torch.float32, "single", "adaptive", False),   # the blocked route
    ("cuda", 341, torch.float32, "single", "adaptive", False),
    ("cuda", 241, torch.float64, "single", "adaptive", False),
    ("cuda", 210, torch.float32, False, "adaptive", False),       # the rescue's full ladder
    ("cuda", 210, torch.float32, True, "adaptive", False),        # the sparse ladder
    ("cuda", 210, torch.float32, "single", "pivot", False),
    ("cpu", 210, torch.float32, "single", "adaptive", False),
    ("cpu", 210, torch.float64, "single", "adaptive", False),
])
def test_the_choice_of_runner(device_type, n, dtype, ladder, nugget, graphed):
    assert fitting._graphed(device_type, n, dtype, ladder, nugget) is graphed


@pytest.mark.parametrize("route,ladder,capturable", [
    (True, "single", True), (False, "single", False), (True, False, False)])
def test_minimize_hands_the_optimizer_what_the_choice_says(monkeypatch, route, ladder,
                                                           capturable):
    x, y = _fit_problem(2, n_out=1)
    gp = mogp_tpu_torch.GaussianProcess(x, y[0], nugget="adaptive", device="cpu")
    seen = []
    monkeypatch.setattr(fitting, "_graphed",
                        lambda dev, n, dt, lad, nug: route and lad == "single")
    monkeypatch.setattr(fitting, "lbfgs_minimize",
                        lambda fun, x0, **kw: seen.append(fun) or lbfgs.lbfgs_minimize(
                            fun, x0, **kw))
    data, starts = _lanes(mogp_tpu_torch.MultiOutputGP(x, y, device="cpu"), 3, 0)
    res = fitting._minimize(starts, data, gp.kernel, "adaptive", 5, None, None, ladder)
    assert isinstance(seen[0], lbfgs.Capturable) is capturable
    if capturable:
        assert seen[0].span == "gp.nlp" and seen[0].args is data
    assert torch.isfinite(res.fun).all()


def test_a_replay_counts_what_the_eager_call_counts(stand_in):
    x, y = _fit_problem(3)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, nugget="adaptive", device="cpu")
    data, starts = _lanes(mgp, 4, 1)
    em = mgp.emulators[0]
    fun = lbfgs.Capturable(
        lambda raw, d: tgp.gp_nlp(raw, d, em.kernel, "adaptive", sparse_ladder="single",
                                  progressive_ok=False),
        data, (em.kernel, "adaptive", "single"), "gp.nlp")

    def counted(run):
        metrics.clear()
        kb.launches = 0
        with metrics.recording():
            res = run()
        spans = metrics.recorder.counts
        return res, metrics.counters(), kb.launches, dict(spans)

    eager, c_e, k2_e, s_e = counted(
        lambda: lbfgs.lbfgs_minimize(lambda raw: fun.fn(raw, data), starts, maxiter=20))
    first, c_1, _, _ = counted(lambda: _graphed(fun, starts, 20))     # captures
    again, c_g, k2_g, s_g = counted(lambda: _graphed(fun, starts, 20))  # replays only
    _same(first, eager)
    _same(again, eager)
    lanes = starts.shape[0]
    evals = c_e["lbfgs.evals_eager"]
    assert evals == c_e["gp.nlp_lanes"] and evals % lanes == 0
    # the capture's warm-ups are eager evaluations; the capture runs nothing
    assert c_1["lbfgs.evals_eager"] == graphs.WARMUPS * lanes
    assert c_1["lbfgs.evals_graphed"] == evals
    assert c_g == {"gp.nlp_lanes": evals, "chol.matrices": c_e["chol.matrices"],
                   "lbfgs.evals_graphed": evals}
    assert k2_g == k2_e == evals // lanes
    # one span a replay where the eager call has the forward's and the
    # backward's; the host's reads of the flags as many
    assert s_g["gp.nlp"] == s_e["gp.nlp"] == s_e["lbfgs.grad"] and "lbfgs.grad" not in s_g
    assert s_g["lbfgs.sync"] == s_e["lbfgs.sync"]


def test_a_graph_replay_adds_its_recorded_launches_and_counts():
    class Fake:
        replays = 0

        def replay(self):
            self.replays += 1

    fake = Fake()
    graph = graphs.Graph(fake, 3, {"gp.nlp_lanes": 7, "chol.matrices": 7})
    metrics.clear()
    kb.launches = 0
    graph.replay()   # recorder off: the launches count, the counters do not
    with metrics.recording():
        graph.replay()
        graph.replay()
    assert fake.replays == 3 and kb.launches == 9
    assert metrics.counters() == {"gp.nlp_lanes": 14, "chol.matrices": 14}
    metrics.clear()
    kb.launches = 0


def test_a_tally_takes_the_counts_and_records_no_span():
    x, y = _fit_problem(4, n_out=1)
    gp = mogp_tpu_torch.GaussianProcess(x, y[0], nugget="adaptive", device="cpu")
    data = tgp.take_lanes(gp._data, torch.zeros(3, dtype=torch.int64))
    raw = torch.zeros(3, gp.n_params, dtype=torch.float64)
    metrics.clear()
    with metrics.recording():
        with metrics.tally() as counts:
            tgp.gp_nlp(raw, data, gp.kernel, "adaptive", sparse_ladder="single")
            assert not metrics.enabled()
        assert metrics.enabled()
    assert counts == {"gp.nlp_lanes": 3, "chol.matrices": 3}
    assert metrics.counters() == {} and metrics.spans() == []


def test_the_graph_cache_drops_its_oldest_entry_at_its_bound(stand_in):
    args = _quadratic_args(1, 3, 5)

    def run(lanes):
        H, c = (a.expand(lanes, *a.shape[1:]).contiguous() for a in args)
        fun = lbfgs.Capturable(_quadratic, (H, c), "quadratic", "quadratic")
        return _graphed(fun, torch.zeros(lanes, 3, dtype=torch.float64), 5)

    size = lbfgs.GRAPH_CACHE_SIZE
    for lanes in range(1, size + 1):
        run(lanes)
    run(1)                       # the first entry is used again: the newest
    run(size + 1)                # one more: the least recently used goes
    kept = _kept()
    assert len(kept) == size and kept == list(range(3, size + 1)) + [1, size + 1]
    before = len(_captures)
    run(1)                       # a hit captures nothing
    assert len(_captures) == before


def test_each_card_of_a_mesh_keeps_its_own_captures(stand_in):
    """A 64-output fit over four cards: each card's shard runs a 240-lane
    and a 64-lane stage, and cuda:0 also holds the unsharded fit's 960 and
    256 lanes.  Ten locksteps in all, four at most a card: a second
    round of the same fits captures nothing."""
    cards = [torch.device("cuda", i) for i in range(4)]
    args = _quadratic_args(1, 3, 6)

    def stage(device, lanes):
        H, c = (a.expand(lanes, *a.shape[1:]).contiguous() for a in args)
        fun = lbfgs.Capturable(_quadratic, (H, c), "quadratic", "quadratic")
        x0 = torch.zeros(lanes, 3, dtype=torch.float64)
        gtol, ftol = lbfgs._tolerances(x0.dtype)
        key = (x0.dtype, tuple(x0.shape), 10, gtol, ftol, 1e-4, fun.key,
               tuple((tuple(a.shape), a.dtype) for a in fun.args))
        # _run_graphed's lookup, on a card the CPU cannot hold a tensor on
        entry = lbfgs._captured(device, key, lambda: lbfgs._Captured(fun, x0, 10, gtol, ftol,
                                                                     1e-4))
        entry.load(fun.args, x0)
        return lbfgs._drive(entry.ls, entry.steps, 5, 2)

    def fits():
        for lanes in (960, 256):
            stage(cards[0], lanes)
        for lanes in (240, 64):
            for card in cards:
                stage(card, lanes)

    before = len(_captures)
    fits()
    made = len(_captures)
    assert made - before == 5 * 10   # five segment graphs a lockstep
    fits()
    assert len(_captures) == made
    assert [sorted(_kept(card)) for card in cards] == [[64, 240, 256, 960]] + [[64, 240]] * 3
    stage(cards[1], 1)      # a new shape on cuda:1 evicts nothing on cuda:0
    assert sorted(_kept(cards[0])) == [64, 240, 256, 960]
