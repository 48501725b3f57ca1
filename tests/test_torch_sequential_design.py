"""The port's SequentialDesign / MICEDesign / MICEFastGP against ``mogp_tpu``'s.

Port of ``tests/test_sequential_design.py`` and of the MICE tests of
``tests/test_uq.py`` on ``device="cpu"`` (float64), plus parity with
``mogp_tpu``: ``fast_predict_all`` within rtol 1e-10, design files that
cross between the packages both ways, and seeded ``MICEDesign`` runs that
choose the same candidate rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch import GaussianProcess, GPPriors  # noqa: E402
from mogp_tpu_torch.ops._build import KernelError  # noqa: E402
from mogp_tpu_torch.uq import sequential_design as tsd  # noqa: E402
from mogp_tpu_torch.uq.experimental_design import (  # noqa: E402
    LatinHypercubeDesign,
    MonteCarloDesign,
)

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def SequentialDesign(*args, **kw):
    return tsd.SequentialDesign(*args, **dict(CPU, **kw))


def MICEDesign(*args, **kw):
    return tsd.MICEDesign(*args, **dict(CPU, **kw))


def MICEFastGP(*args, **kw):
    return tsd.MICEFastGP(*args, **dict(CPU, **kw))


def f_sim(x):
    return np.sum(x**2)


# -- constructor --------------------------------------------------------------


def test_init_defaults_and_accessors():
    sd = SequentialDesign(LatinHypercubeDesign(3))
    assert sd.get_n_parameters() == 3
    assert sd.get_n_init() == 10
    assert sd.get_n_cand() == 50
    assert sd.get_n_samples() is None
    assert sd.get_current_iteration() == 0
    assert sd.get_inputs() is None
    assert sd.get_targets() is None
    assert sd.get_candidates() is None
    assert not sd.has_function()
    assert sd.get_base_design() == "LatinHypercubeDesign"
    assert sd.device == torch.device("cpu") and sd.dtype == torch.float64


def test_init_explicit_args():
    sd = SequentialDesign(MonteCarloDesign(2), f_sim, n_samples=5, n_init=4, n_cand=7)
    assert sd.has_function()
    assert sd.get_n_samples() == 5
    assert sd.get_n_init() == 4
    assert sd.get_n_cand() == 7
    assert sd.get_base_design() == "MonteCarloDesign"


def test_init_failures():
    ed = LatinHypercubeDesign(2)
    with pytest.raises(TypeError):
        SequentialDesign("not a design")
    with pytest.raises(TypeError):
        SequentialDesign(ed, f="not callable")
    with pytest.raises(ValueError):
        SequentialDesign(ed, f=lambda a, b: a + b)
    with pytest.raises(ValueError):
        SequentialDesign(ed, n_samples=-1)
    with pytest.raises(ValueError):
        SequentialDesign(ed, n_init=0)
    with pytest.raises(ValueError):
        SequentialDesign(ed, n_cand=0)


# -- initial design state machine ---------------------------------------------


def test_generate_initial_design():
    np.random.seed(100)
    sd = SequentialDesign(LatinHypercubeDesign(2), n_init=6)
    inputs = sd.generate_initial_design()
    assert inputs.shape == (6, 2)
    assert np.all((inputs >= 0.0) & (inputs <= 1.0))
    assert sd.get_current_iteration() == 6
    sd.set_initial_targets(np.zeros(6))
    with pytest.raises(AssertionError):
        sd.generate_initial_design()


def test_set_initial_targets_validation():
    np.random.seed(101)
    sd = SequentialDesign(LatinHypercubeDesign(2), n_init=4)
    with pytest.raises(ValueError):
        sd.set_initial_targets(np.zeros(4))
    sd.generate_initial_design()
    with pytest.raises(AssertionError):
        sd.set_initial_targets(np.zeros(3))
    sd.set_initial_targets(np.arange(4.0)[:, None])
    assert sd.get_targets().shape == (4,)
    assert sd.initialized


def test_run_initial_design_requires_function():
    sd = SequentialDesign(LatinHypercubeDesign(2), n_init=3)
    with pytest.raises(AssertionError):
        sd.run_initial_design()


def test_run_initial_design_evaluates_simulator():
    np.random.seed(102)
    sd = SequentialDesign(LatinHypercubeDesign(2), f_sim, n_init=5)
    sd.run_initial_design()
    assert_allclose(sd.get_targets(), np.sum(sd.get_inputs() ** 2, axis=1), rtol=1e-12)


# -- next-point / target state machine ----------------------------------------


def test_get_next_point_errors():
    sd = SequentialDesign(LatinHypercubeDesign(2), n_init=3)
    with pytest.raises(ValueError):
        sd.get_next_point()
    sd.generate_initial_design()
    with pytest.raises(ValueError):
        sd.get_next_point()
    with pytest.raises(AssertionError):
        sd.set_next_target(1.0)


def test_base_eval_metric_not_implemented():
    np.random.seed(103)
    sd = SequentialDesign(LatinHypercubeDesign(2), n_init=3)
    sd.generate_initial_design()
    sd.set_initial_targets(np.zeros(3))
    with pytest.raises(NotImplementedError):
        sd.get_next_point()
    with pytest.raises(NotImplementedError):
        sd._estimate_next_target(np.zeros(2))


def test_set_next_target_shape_checks():
    np.random.seed(104)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=5, n_cand=8)
    md.generate_initial_design()
    md.set_initial_targets(np.linspace(0.0, 1.0, 5))
    pt = md.get_next_point()
    assert pt.shape == (2,)
    assert md.get_inputs().shape == (6, 2)
    with pytest.raises(AssertionError):
        md.set_next_target(np.array([1.0, 2.0]))
    md.set_next_target(0.5)
    assert md.get_current_iteration() == 6
    assert md.get_targets().shape == (6,)
    with pytest.raises(AssertionError):
        md.set_next_target(0.5)


def test_mice_next_point_comes_from_candidates():
    np.random.seed(105)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=6, n_cand=12)
    md.generate_initial_design()
    md.set_initial_targets(np.sin(3 * md.get_inputs()[:, 0]))
    pt = md.get_next_point()
    cands = md.get_candidates()
    assert cands.shape == (12, 2)
    assert np.min(np.sum((cands - pt) ** 2, axis=1)) < 1e-24


def test_batch_points_state_and_restore():
    np.random.seed(106)
    md = MICEDesign(LatinHypercubeDesign(2), f_sim, n_init=5, n_cand=8)
    md.run_initial_design()
    t_before = md.get_targets().copy()
    batch = md.get_batch_points(3)
    assert batch.shape == (3, 2)
    assert md.get_current_iteration() == 5
    assert_allclose(md.get_targets(), t_before)
    assert md.get_inputs().shape == (8, 2)
    md.set_batch_targets(np.array([f_sim(b) for b in batch]))
    assert md.get_current_iteration() == 8
    with pytest.raises(AssertionError):
        md.get_batch_points(0)


def test_set_batch_targets_wrong_length():
    np.random.seed(107)
    md = MICEDesign(LatinHypercubeDesign(2), f_sim, n_init=5, n_cand=8)
    md.run_initial_design()
    md.get_batch_points(2)
    with pytest.raises(AssertionError):
        md.set_batch_targets(np.zeros(3))


def test_run_sequential_design_needs_n_samples():
    md = MICEDesign(LatinHypercubeDesign(2), f_sim, n_init=4, n_cand=6)
    with pytest.raises(ValueError):
        md.run_sequential_design()


def test_str_contains_state():
    md = MICEDesign(LatinHypercubeDesign(2), f_sim, n_samples=3, n_init=4, n_cand=6)
    s = str(md)
    assert "MICEDesign" in s
    assert "LatinHypercubeDesign" in s
    assert "bound simulator function" in s
    assert "3 total samples" in s
    assert "4 initial points" in s
    assert "6 candidate points" in s


# -- persistence --------------------------------------------------------------


def test_save_load_empty_design(tmp_path):
    sd = SequentialDesign(LatinHypercubeDesign(2), n_init=4)
    fname = str(tmp_path / "empty.npz")
    sd.save_design(fname)
    sd2 = SequentialDesign(LatinHypercubeDesign(2), n_init=4)
    sd2.load_design(fname)
    assert sd2.get_inputs() is None
    assert sd2.get_targets() is None
    assert sd2.get_candidates() is None
    assert not sd2.initialized


def test_save_load_inputs_only(tmp_path):
    np.random.seed(108)
    sd = SequentialDesign(LatinHypercubeDesign(3), n_init=5)
    sd.generate_initial_design()
    fname = str(tmp_path / "inputs_only.npz")
    sd.save_design(fname)
    sd2 = SequentialDesign(LatinHypercubeDesign(3), n_init=5)
    sd2.load_design(fname)
    assert_allclose(sd2.get_inputs(), sd.get_inputs())
    assert sd2.get_targets() is None
    assert not sd2.initialized


def test_load_design_dimension_mismatch(tmp_path):
    np.random.seed(109)
    sd = SequentialDesign(LatinHypercubeDesign(3), n_init=5)
    sd.generate_initial_design()
    fname = str(tmp_path / "d3.npz")
    sd.save_design(fname)
    sd2 = SequentialDesign(LatinHypercubeDesign(2), n_init=5)
    with pytest.raises(AssertionError):
        sd2.load_design(fname)


def test_load_design_partial_targets(tmp_path):
    np.random.seed(110)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=5, n_cand=8)
    md.generate_initial_design()
    md.set_initial_targets(np.arange(5.0))
    md.get_next_point()
    fname = str(tmp_path / "partial.npz")
    md.save_design(fname)
    md2 = MICEDesign(LatinHypercubeDesign(2), n_init=5, n_cand=8)
    md2.load_design(fname)
    assert md2.get_inputs().shape == (6, 2)
    assert md2.get_current_iteration() == 5
    assert md2.initialized
    md2.set_next_target(1.5)
    assert md2.get_current_iteration() == 6


@pytest.mark.parametrize("writer", ["mogp_tpu", "mogp_tpu_torch"])
def test_design_files_cross_between_the_packages(tmp_path, writer):
    """A design file written mid-acquisition by one package loads in the
    other with the same arrays and state."""
    src, dst = (mogp_tpu, mogp_tpu_torch) if writer == "mogp_tpu" else (mogp_tpu_torch, mogp_tpu)

    def kw(pkg):
        return CPU if pkg is mogp_tpu_torch else {}

    np.random.seed(114)
    md = src.MICEDesign(src.LatinHypercubeDesign(2), n_init=5, n_cand=8, **kw(src))
    md.generate_initial_design()
    md.set_initial_targets(np.arange(5.0))
    md._generate_candidates()
    md.inputs = np.vstack([md.inputs, md.candidates[:1]])
    fname = str(tmp_path / "cross.npz")
    md.save_design(fname)
    md2 = dst.MICEDesign(dst.LatinHypercubeDesign(2), n_init=5, n_cand=8, **kw(dst))
    md2.load_design(fname)
    assert_allclose(md2.get_inputs(), md.get_inputs(), rtol=0, atol=0)
    assert_allclose(md2.get_targets(), md.get_targets(), rtol=0, atol=0)
    assert_allclose(md2.get_candidates(), md.get_candidates(), rtol=0, atol=0)
    assert md2.get_current_iteration() == 5 and md2.initialized
    empty = str(tmp_path / "empty.npz")
    src.SequentialDesign(src.LatinHypercubeDesign(2), **kw(src)).save_design(empty)
    sd = dst.SequentialDesign(dst.LatinHypercubeDesign(2), **kw(dst))
    sd.load_design(empty)
    assert sd.get_inputs() is None and not sd.initialized


# -- MICEDesign specifics ------------------------------------------------------


def test_mice_init_validation():
    ed = LatinHypercubeDesign(2)
    md = MICEDesign(ed, nugget=1e-6, nugget_s=2.0)
    assert md.get_nugget() == pytest.approx(1e-6)
    assert md.get_nugget_s() == pytest.approx(2.0)
    assert MICEDesign(ed).get_nugget() == "adaptive"
    with pytest.raises(ValueError):
        MICEDesign(ed, nugget=-1.0)
    with pytest.raises(ValueError):
        MICEDesign(ed, nugget_s=-1.0)
    with pytest.raises(TypeError):
        MICEDesign(ed, nugget=[1.0])


def _loo_variance_oracle(gp_fast, idx):
    """Explicit-inverse numpy oracle for the Woodbury LOO variance."""
    X = np.asarray(gp_fast.inputs)
    cov = float(gp_fast.theta.cov)
    nugget = float(gp_fast.nugget)
    d2 = np.sum((X[:, None, :] - X[None, :, :]) ** 2 * np.exp(gp_fast.theta.corr_raw), axis=-1)
    C = cov * np.exp(-0.5 * d2)
    Q = C + nugget * np.eye(len(X))
    mask = np.arange(len(X)) != idx
    k = C[mask, idx]
    return float(cov + nugget - k @ np.linalg.solve(Q[np.ix_(mask, mask)], k))


def test_mice_criterion_oracle():
    """_MICE_criterion equals predict-variance / LOO-variance computed with
    independent numpy linear algebra."""
    np.random.seed(111)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=8, n_cand=6, nugget=1e-6, nugget_s=1.0)
    md.generate_initial_design()
    md.set_initial_targets(np.sin(4 * md.get_inputs()[:, 0]) + md.get_inputs()[:, 1])
    md._generate_candidates()
    md._eval_metric()

    for j in [0, 3, 5]:
        crit = md._MICE_criterion(j)
        _, unc1, _ = md.gp.predict(md.get_candidates()[j], unc=True)
        unc1 = float(np.asarray(unc1).ravel()[0])
        assert_allclose(crit, unc1 / _loo_variance_oracle(md.gp_fast, j), rtol=1e-5)

    with pytest.raises(AssertionError):
        md._MICE_criterion(-1)
    with pytest.raises(AssertionError):
        md._MICE_criterion(6)


def test_mice_fast_predict_all_indices():
    """The Woodbury LOO identity for every index at once."""
    np.random.seed(112)
    X = np.random.rand(15, 3)
    gp_fast = MICEFastGP(X, np.ones(15), nugget=0.05)
    gp_fast.fit(np.array([0.3, -0.2, 0.1, 0.4]))
    got = gp_fast.fast_predict_all()
    want = np.array([_loo_variance_oracle(gp_fast, i) for i in range(15)])
    assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("nugget", [0.05, 0.5])
def test_fast_predict_all_matches_mogp_tpu(nugget):
    """``fast_predict_all`` against mogp_tpu's on the same candidates and
    hyperparameters.  (With a nugget near 1e-6 the variances, ~1e-6 of
    sigma2, are what is left of sigma2 - k^T Q^-1 k at condition ~1e7, and
    the two packages' rounding orders part at ~1e-4 of them.)"""
    X = np.random.RandomState(115).rand(20, 2)
    theta = np.array([0.4, -0.3, 0.2])
    ours = MICEFastGP(X, np.ones(20), nugget=nugget)
    ours.fit(theta)
    ref = mogp_tpu.MICEFastGP(X, np.ones(20), nugget=nugget)
    ref.fit(theta)
    assert_allclose(ours.fast_predict_all(), ref.fast_predict_all(), rtol=1e-10)
    assert_allclose(ours.fast_predict(7), ref.fast_predict(7), rtol=1e-10)


def test_loo_identity_keeps_float32_digits():
    """``_loo_variances_all`` (``1 / [Q^-1]_ii``) against mogp_tpu's blockwise
    sum over ``L^-1 [C | I]``, written out here: the same function in
    float64; in float32 at the candidate GP's nugget floor (1e3 eps32
    sigma2, 400 candidates in the unit square) the identity keeps its
    digits and the blockwise sum, which subtracts terms of sigma2^2 / nu,
    keeps none."""
    X = np.random.RandomState(3).uniform(0, 1, (400, 2))
    s2 = 2.0
    C = s2 * np.exp(-0.5 * np.sum((X[:, None] - X[None]) ** 2 * np.e, axis=-1))
    nu = 1e3 * np.finfo(np.float32).eps * s2

    def both(dtype):
        Ct = torch.as_tensor(C, dtype=dtype)
        eye = torch.eye(len(X), dtype=dtype)
        L = torch.linalg.cholesky(Ct + nu * eye)
        V = torch.linalg.solve_triangular(L, eye, upper=False)
        W = torch.linalg.solve_triangular(L, Ct, upper=False)
        P1, P2, Iii = (W * W).sum(-2), (V * W).sum(-2), (V * V).sum(-2)
        quad = P1 - 2 * s2 * P2 + s2**2 * Iii - (P2 - s2 * Iii) ** 2 / Iii
        blockwise = torch.clamp_min(s2 + nu - quad, 0.0)
        return tsd._loo_variances_all(V).double().numpy(), blockwise.double().numpy()

    ours64, ref64 = both(torch.float64)
    ours32, ref32 = both(torch.float32)
    assert_allclose(ours64, ref64, rtol=1e-6)
    err_ours = np.abs(ours32 - ours64) / ours64
    err_ref = np.abs(ref32 - ours64) / ours64
    assert err_ours.max() < 1e-2
    assert np.median(err_ref) > 100 * np.median(err_ours)


def test_mice_estimate_next_target_matches_prediction():
    np.random.seed(113)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=8, n_cand=6)
    md.generate_initial_design()
    md.set_initial_targets(5.0 + 3.0 * np.cos(3 * md.get_inputs()[:, 0]))
    pt = md.get_next_point()
    est = md._estimate_next_target(pt)
    mu = md.gp.predict(pt)[0] * md._t_std + md._t_mean
    assert_allclose(np.asarray(est), np.asarray(mu), rtol=1e-10)
    with pytest.raises(AssertionError):
        md._estimate_next_target(np.zeros(3))


def test_seeded_mice_design_chooses_mogp_tpus_points():
    """A seeded run of each package: the same initial design, candidates
    and chosen rows (two acquisitions)."""
    def run(pkg, **kw):
        np.random.seed(116)
        md = pkg.MICEDesign(pkg.LatinHypercubeDesign(2), lambda x: np.sin(5 * x[0]) + x[1],
                            n_samples=2, n_init=6, n_cand=15, **kw)
        md.run_sequential_design()
        return md

    ours, ref = run(mogp_tpu_torch, **CPU), run(mogp_tpu)
    assert_allclose(ours.get_inputs(), ref.get_inputs(), rtol=0, atol=0)
    assert_allclose(ours.get_targets(), ref.get_targets(), rtol=0, atol=0)
    assert_allclose(ours.gp.theta.get_data(), ref.gp.theta.get_data(), rtol=1e-7)


def test_mice_retries_numerical_failures_and_raises_kernel_errors(monkeypatch):
    """The ten-try loop refits on a numerical failure, as mogp_tpu's does,
    and raises a kernel's build or launch failure at once."""
    calls = []

    def failing(exc):
        def fit(gp, *a, **kw):
            calls.append(exc)
            raise exc
        return fit

    np.random.seed(117)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=5, n_cand=8)
    md.generate_initial_design()
    md.set_initial_targets(np.arange(5.0))
    md._generate_candidates()
    monkeypatch.setattr(tsd, "fit_GP_MAP", failing(RuntimeError("GP fitting failed")))
    with pytest.raises(RuntimeError, match="Unable to find parameters"):
        md._eval_metric()
    assert len(calls) == 10
    del calls[:]
    monkeypatch.setattr(tsd, "fit_GP_MAP", failing(KernelError("launch failed")))
    with pytest.raises(KernelError, match="launch failed"):
        md._eval_metric()
    assert len(calls) == 1


# -- ports of the MICE tests of tests/test_uq.py ---------------------------------


def test_mice_design_runs():
    np.random.seed(40)

    def f(x):
        return np.sin(5 * x[0]) + np.cos(3 * x[1])

    md = MICEDesign(LatinHypercubeDesign(2), f, n_samples=2, n_init=6, n_cand=15)
    md.run_sequential_design()
    assert md.get_inputs().shape == (8, 2)
    assert md.get_targets().shape == (8,)
    assert md.get_current_iteration() == 8
    assert np.all(md.get_inputs() >= 0) and np.all(md.get_inputs() <= 1)


def test_mice_fast_predict_matches_direct():
    """The Woodbury LOO variance against a direct refit without the index."""
    np.random.seed(41)
    X = np.random.rand(12, 2)
    nugget = 0.1
    gp_fast = MICEFastGP(X, np.ones(12), nugget=nugget)
    theta = np.array([0.5, -0.3, 0.2])
    gp_fast.fit(theta)
    all_vars = gp_fast.fast_predict_all()
    for idx in [0, 5, 11]:
        mask = np.arange(12) != idx
        gp_ref = GaussianProcess(X[mask], np.ones(11), nugget=nugget,
                                 priors=GPPriors(n_corr=2, nugget_type="fixed"), **CPU)
        gp_ref.fit(theta)
        _, var_ref, _ = gp_ref.predict(X[idx])
        assert_allclose(all_vars[idx], var_ref[0], rtol=1e-6)
        assert_allclose(gp_fast.fast_predict(idx), var_ref[0], rtol=1e-6)


def test_sequential_design_save_load(tmp_path):
    np.random.seed(42)
    md = MICEDesign(LatinHypercubeDesign(2), n_init=5, n_cand=10)
    md.generate_initial_design()
    md.set_initial_targets(np.arange(5.0))
    fname = str(tmp_path / "design.npz")
    md.save_design(fname)
    md2 = MICEDesign(LatinHypercubeDesign(2), n_init=5, n_cand=10)
    md2.load_design(fname)
    assert_allclose(md2.get_inputs(), md.get_inputs())
    assert_allclose(md2.get_targets(), md.get_targets())
    assert md2.get_current_iteration() == 5
    assert md2.initialized


def test_batch_points():
    np.random.seed(43)

    def f(x):
        return float(np.sum(x**2))

    md = MICEDesign(LatinHypercubeDesign(2), f, n_init=5, n_cand=10)
    md.run_initial_design()
    batch = md.get_batch_points(2)
    assert batch.shape == (2, 2)
    md.set_batch_targets(np.array([f(b) for b in batch]))
    assert md.get_current_iteration() == 7


def test_sequential_design_custom_metric():
    """Subclassing SequentialDesign with a custom metric."""
    from scipy.spatial.distance import cdist

    class GreedyFarthest(tsd.SequentialDesign):
        def _eval_metric(self):
            return int(np.argmax(cdist(self.candidates, self.inputs).min(axis=1)))

    np.random.seed(61)
    sd = GreedyFarthest(LatinHypercubeDesign(2), lambda x: float(x.sum()), n_init=4, n_cand=20,
                        **CPU)
    sd.run_initial_design()
    for _ in range(3):
        sd.run_next_point()
    assert sd.get_inputs().shape == (7, 2)
    assert sd.get_targets().shape == (7,)
