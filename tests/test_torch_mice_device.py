"""The port's fixed-shape device MICE against ``mogp_tpu``'s.

Port of ``tests/test_mice_device.py``, in float64 on the CPU, each case
run through both packages on the same seeded inputs: the masked negative
log posterior against ``mogp_tpu``'s and against the port's own
``gp_nlp`` on the observed sub-design; the score step against
``mogp_tpu``'s ``_mice_score_step`` (scores rtol 1e-7, means rtol 1e-8);
seeded design loops that choose the same points.  The JAX package's
"two compiled programs" test becomes a check that every step hands the fit
and the score step the same shapes; its mesh test is in
``tests/test_torch_parallel_uq.py``, and here a ``mesh=`` that is not a
``parallel.DeviceMesh`` is refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.models import gp as jgp  # noqa: E402
from mogp_tpu.models.priors import GPPriors as JPriors  # noqa: E402
from mogp_tpu.ops.kernels import get_kernel as jkernel  # noqa: E402
from mogp_tpu.uq import mice_device as jmd  # noqa: E402
from mogp_tpu_torch.models import gp as tgp  # noqa: E402
from mogp_tpu_torch.models.priors import GPPriors as TPriors  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.ops import predict_fused as tpf  # noqa: E402
from mogp_tpu_torch.ops.kernels import get_kernel as tkernel  # noqa: E402
from mogp_tpu_torch.uq import mice_device as tmd  # noqa: E402

torch.set_num_threads(2)

JK, TK = jkernel("SquaredExponential"), tkernel("SquaredExponential")
EPS = np.finfo(np.float64).eps
# the masked objective against gp_nlp on the sub-design, in either package
RTOL_NLP = 1e-10
# the score step against mogp_tpu's (float64 on both sides)
RTOL_SCORES, RTOL_MU = 1e-7, 1e-8


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _problem(n, D=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, size=(n, D))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    return x, y


def _data(pkg_gp, priors_cls, x, y, n_obs, nugget_type, nugget_value=0.0, **kw):
    priors = priors_cls.default_priors(x[:n_obs], x.shape[1], nugget_type=nugget_type)
    return pkg_gp.make_gp_data(x, y, np.zeros((len(x), 0)), priors, nugget_value=nugget_value,
                               **kw)


def _mask(n_max, n_obs):
    return (np.arange(n_max) < n_obs).astype(np.float64)


def _rtol_for(x, raw, nugget):
    """``RTOL_NLP``, or the float64 rounding floor of the sub-design's
    objective where that is larger: one ulp of K (+ nugget) moves the NLP
    by up to ``eps * cond(K)``.  The port zeroes the diagonal's r2 exactly and
    ``mogp_tpu`` leaves its rounding there, and torch's matmul rounds the
    observed block of an (n_max, n_max) K differently from an (n_obs,
    n_obs) one; at this problem's long correlation lengths (the JAX
    package's test problem) the adaptive sub-designs of 11 and 16 points
    factor without jitter at condition 2.9e7 and 6.9e9."""
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2 * np.exp(raw[: x.shape[1]]), axis=-1)
    K = np.exp(raw[x.shape[1]]) * np.exp(-0.5 * d2) + nugget * np.eye(len(x))
    return max(RTOL_NLP, EPS * np.linalg.cond(K))


@pytest.mark.parametrize("nugget_type", ["adaptive", "fit", "fixed"])
@pytest.mark.parametrize("n_obs", [5, 11, 16])
def test_masked_nlp_equals_subdesign_nlp(nugget_type, n_obs):
    n_max, D = 16, 2
    x, y = _problem(n_max, D)
    nugget_value = 1e-6 if nugget_type == "fixed" else 0.0
    raw = np.linspace(-0.5, 0.5, D + 1 + (nugget_type == "fit"))

    # padded rows carry garbage
    x_pad, y_pad = x.copy(), y.copy()
    x_pad[n_obs:] = 123.456
    y_pad[n_obs:] = -999.0
    mask = _mask(n_max, n_obs)

    sub = _data(tgp, TPriors, x[:n_obs], y[:n_obs], n_obs, nugget_type, nugget_value,
                device="cpu")
    nlp_sub = tgp.gp_nlp(_t(raw)[None], sub, TK, nugget_type)[0].item()
    pad = _data(tgp, TPriors, x_pad, y_pad, n_obs, nugget_type, nugget_value, device="cpu")
    nlp_masked = tmd.masked_gp_nlp(_t(raw)[None], pad, _t(mask), TK, nugget_type)[0].item()
    jpad = _data(jgp, JPriors, x_pad, y_pad, n_obs, nugget_type, nugget_value)
    nlp_jax = float(jmd.masked_gp_nlp(jnp.asarray(raw), jpad, jnp.asarray(mask), JK,
                                      nugget_type))

    # the adaptive sub-design factors without jitter here: its rounding floor
    rtol = _rtol_for(x[:n_obs], raw, 0.0) if nugget_type == "adaptive" else RTOL_NLP
    assert_allclose(nlp_masked, nlp_sub, rtol=rtol)
    assert_allclose(nlp_masked, nlp_jax, rtol=rtol)


@pytest.mark.parametrize("nugget_type", ["adaptive", "fit", "fixed"])
def test_masked_rows_are_exact_unit_pivots(nugget_type):
    """The masked factor: the masked rows' pivots exactly 1, nothing
    coupling them to the observed rows, the observed block the factor of
    the observed covariance with the jitter (or nugget) and its
    ``mean(diag)`` taken over the observed rows only."""
    n_max, n_obs = 14, 9
    x, _ = _problem(n_max, seed=4)
    x[n_obs:] = 50.0
    raw = np.array([1.0, 1.5, 0.3])
    K = np.exp(raw[2]) * TK.kernel_f(_t(x), _t(x), _t(raw[:2])).numpy()
    mask = _mask(n_max, n_obs)
    Kt = mask[:, None] * mask[None, :] * K + np.diag(1.0 - mask)
    F, nug = tchol.cholesky_factor(_t(Kt)[None], _t([1e-3]), nugget_type, jitter_mask=_t(mask))
    L = F.L[0].numpy()
    assert np.all(L[n_obs:, n_obs:] == np.eye(n_max - n_obs))
    assert np.all(L[n_obs:, :n_obs] == 0.0)
    add = 0.0 if nugget_type == "adaptive" else 1e-3
    Fs, nug_s = tchol.cholesky_factor(_t(K[:n_obs, :n_obs])[None], _t([add]), nugget_type)
    assert_allclose(L[:n_obs, :n_obs], Fs.L[0].numpy(), rtol=1e-12, atol=1e-14)
    assert nug.item() == nug_s.item()
    assert_allclose(F.logdet().item(), Fs.logdet().item(), rtol=1e-12)


def test_masked_nlp_gradient_matches_jax():
    """The objective's autograd gradient (what the per-step L-BFGS
    follows) against ``jax.grad`` of ``mogp_tpu``'s."""
    import jax

    n_max, n_obs, D = 14, 10, 2
    x, y = _problem(n_max, D, seed=2)
    mask = _mask(n_max, n_obs)
    raw = np.array([1.2, 0.8, 0.1, -2.0])
    data = _data(tgp, TPriors, x, y, n_obs, "fit", device="cpu")
    r = _t(raw)[None].requires_grad_(True)
    (g,) = torch.autograd.grad(tmd.masked_gp_nlp(r, data, _t(mask), TK, "fit")[0], r)
    jdata = _data(jgp, JPriors, x, y, n_obs, "fit")
    gj = jax.grad(lambda q: jmd.masked_gp_nlp(q, jdata, jnp.asarray(mask), JK, "fit"))(
        jnp.asarray(raw))
    assert_allclose(g[0].numpy(), np.asarray(gj), rtol=1e-9, atol=1e-10)


def test_masked_nlp_respects_sparse_ladder():
    n_max, D, n_obs = 12, 2, 8
    x, y = _problem(n_max, D, seed=3)
    data = _data(tgp, TPriors, x, y, n_obs, "adaptive", device="cpu")
    jdata = _data(jgp, JPriors, x, y, n_obs, "adaptive")
    mask = _mask(n_max, n_obs)
    raw = np.linspace(-0.3, 0.3, D + 1)

    def nlp(ladder):
        return tmd.masked_gp_nlp(_t(raw)[None], data, _t(mask), TK, "adaptive",
                                 sparse_ladder=ladder)[0].item()

    a, b, c = nlp(False), nlp(True), nlp("single")
    # the sparse ladder includes the zero rung: the same value
    assert_allclose(a, b, rtol=1e-10)
    # the one-rung ladder always adds 1e-6 mean(diag): a small perturbation
    assert abs(c - a) < 1e-2 * max(1.0, abs(a))
    for ladder, got in ((False, a), ("single", c)):
        want = float(jmd.masked_gp_nlp(jnp.asarray(raw), jdata, jnp.asarray(mask), JK,
                                       "adaptive", sparse_ladder=ladder))
        assert_allclose(got, want, rtol=_rtol_for(x[:n_obs], raw, 0.0))


def _score_port(x, y, n_obs, raw, blocks, cmask, fast_nugget, nugget_s=0.0,
                nugget_type="adaptive", kernel="SquaredExponential"):
    """``(scores, mu)`` of the port's score step."""
    data = _data(tgp, TPriors, x, y, n_obs, nugget_type, device="cpu")
    st, mt = tmd._mice_score_step(_t(raw), data, _t(_mask(len(x), n_obs)), _t(blocks),
                                  _t(cmask), fast_nugget, nugget_s, tkernel(kernel), nugget_type,
                                  True)
    return st.numpy(), mt.numpy()


def _score_both(x, y, n_obs, raw, blocks, cmask, fast_nugget, nugget_s=0.0,
                nugget_type="adaptive", kernel="SquaredExponential"):
    """``(scores, mu)`` of the port's and of mogp_tpu's score step."""
    jdata = _data(jgp, JPriors, x, y, n_obs, nugget_type)
    sj, mj = jmd._mice_score_step(jnp.asarray(raw), jdata, jnp.asarray(_mask(len(x), n_obs)),
                                  jnp.asarray(blocks), jnp.asarray(cmask),
                                  jnp.asarray(fast_nugget), jnp.asarray(nugget_s),
                                  jkernel(kernel), nugget_type, True)
    return (_score_port(x, y, n_obs, raw, blocks, cmask, fast_nugget, nugget_s, nugget_type,
                        kernel),
            (np.asarray(sj), np.asarray(mj)))


@pytest.mark.parametrize("nugget_s", [0.0, 1.0])
def test_score_step_matches_mogp_tpu_and_micefastgp(nugget_s):
    """The criterion of a dense candidate GP (cand_block >= n_cand) against
    mogp_tpu's score step and against the port's own GaussianProcess +
    MICEFastGP at the same hyperparameters."""
    n_max, n_obs, D, n_cand = 14, 10, 2, 12
    x, y = _problem(n_max, D, seed=5)
    cands = np.random.RandomState(9).uniform(0, 1, size=(n_cand, D))
    raw = np.array([0.2, -0.1, 0.4])
    fast_nugget = 1e-4
    (st, mt), (sj, mj) = _score_both(x, y, n_obs, raw, cands[None], np.ones((1, n_cand)),
                                     fast_nugget, nugget_s)
    assert_allclose(st, sj, rtol=RTOL_SCORES)
    assert_allclose(mt, mj, rtol=RTOL_MU, atol=1e-10)

    priors = TPriors.default_priors(x[:n_obs], D, nugget_type="adaptive")
    gp = mogp_tpu_torch.GaussianProcess(x[:n_obs], y[:n_obs], priors=priors, device="cpu")
    gp.fit(raw)
    mu, unc1, _ = gp.predict(cands)
    fast = mogp_tpu_torch.MICEFastGP(cands, np.ones(n_cand),
                                     nugget=max(gp.nugget * nugget_s, fast_nugget), device="cpu")
    fast.fit(raw)
    assert_allclose(st, unc1 / fast.fast_predict_all(), rtol=RTOL_SCORES)
    assert_allclose(mt, mu, rtol=RTOL_MU, atol=1e-10)


@pytest.mark.parametrize("kernel", ["Matern52", "UniformSqExp", "ProductMat52"])
def test_score_step_matches_mogp_tpu_for_other_kernels(kernel):
    """The other kernel forms: the uniform one through the fused route, the
    product one through K1's and the solves (``gp_predict``'s unfused
    route), each block's covariance through ``kernel_f_predict``."""
    x, y = _problem(14, seed=5)
    cands = np.random.RandomState(9).uniform(0, 1, size=(2, 6, 2))
    raw = np.array([0.2, 0.4]) if kernel == "UniformSqExp" else np.array([0.2, -0.1, 0.4])
    (st, mt), (sj, mj) = _score_both(x, y, 10, raw, cands, np.ones((2, 6)), 1e-4,
                                     kernel=kernel)
    assert_allclose(st, sj, rtol=RTOL_SCORES)
    assert_allclose(mt, mj, rtol=RTOL_MU, atol=1e-10)


def test_score_step_predicts_from_the_observed_rows_only(monkeypatch):
    """The fused prediction is handed the observed rows, the leading block
    of the masked factor and ``sigma2 + nugget``, never a masked row."""
    n_max, n_obs = 14, 10
    x, y = _problem(n_max, seed=5)
    cands = np.random.RandomState(9).uniform(0, 1, size=(2, 8, 2))
    seen = []
    real = tpf.predict_fused

    def spy(x1, x2, exp_theta, sigma2, Lk, alpha, *rest, **kw):
        seen.append((tuple(x1.shape), tuple(Lk.shape), tuple(alpha.shape), rest[-1].item(),
                     sigma2.item()))
        return real(x1, x2, exp_theta, sigma2, Lk, alpha, *rest, **kw)

    monkeypatch.setattr(tpf, "predict_fused", spy)
    data = _data(tgp, TPriors, x, y, n_obs, "fixed", nugget_value=1e-3, device="cpu")
    tmd._mice_score_step(_t([0.2, -0.1, 0.4]), data, _t(_mask(n_max, n_obs)), _t(cands),
                         torch.ones(2, 8, dtype=torch.float64), 1e-4, 0.0, TK, "fixed", True)
    assert len(seen) == 1
    (xs, ls, als, shift, s2) = seen[0]
    assert xs == (1, n_obs, 2) and ls == (1, n_obs, n_obs) and als == (1, n_obs)
    assert_allclose(shift, s2 + 1e-3, rtol=1e-15)
    with pytest.raises(ValueError, match="prefix"):
        tmd._mice_score_step(_t([0.2, -0.1, 0.4]), data, _t(np.roll(_mask(n_max, n_obs), 1)),
                             _t(cands), torch.ones(2, 8, dtype=torch.float64), 1e-4, 0.0, TK,
                             "fixed", True)


def test_score_step_partial_block_not_contaminated():
    """A padded final block scores its real candidates exactly as a dense
    candidate GP on those candidates alone, and as mogp_tpu's step."""
    n_max, n_obs, D = 14, 10, 2
    x, y = _problem(n_max, D, seed=6)
    n_cand, B = 12, 8  # blocks of 8 real and 4 real + 4 padded
    cands = np.random.RandomState(11).uniform(0, 1, size=(n_cand, D))
    raw = np.array([0.3, 0.0, 0.2])
    fast_nugget = 1e-4
    blocks = np.concatenate([cands, np.tile(cands[:1], (2 * B - n_cand, 1))]).reshape(2, B, D)
    cmask = (np.arange(2 * B) < n_cand).astype(np.float64).reshape(2, B)
    (st, _), (sj, _) = _score_both(x, y, n_obs, raw, blocks, cmask, fast_nugget)
    assert_allclose(st[:n_cand], sj[:n_cand], rtol=RTOL_SCORES)

    priors = TPriors.default_priors(x[:n_obs], D, nugget_type="adaptive")
    gp = mogp_tpu_torch.GaussianProcess(x[:n_obs], y[:n_obs], priors=priors, device="cpu")
    gp.fit(raw)
    tail = cands[B:]
    fast = mogp_tpu_torch.MICEFastGP(tail, np.ones(len(tail)), nugget=fast_nugget, device="cpu")
    fast.fit(raw)
    assert_allclose(st[B:n_cand], gp.predict(tail)[1] / fast.fast_predict_all(),
                    rtol=RTOL_SCORES)


def test_block_local_loo_bounded_deviation():
    """The block-local approximation: scores within the JAX package's
    measured bounds of the dense criterion, the deviation shrinking with
    the block, and the block-local argmax near-optimal under the dense
    criterion."""
    rng = np.random.RandomState(0)
    n_obs, D = 20, 2
    x = rng.uniform(0, 1, size=(n_obs, D))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    raw = np.array([0.5, 0.3, 0.0])
    n_cand = 2048
    cands = rng.uniform(0, 1, size=(n_cand, D))

    def scores(B):
        nb = n_cand // B
        return _score_port(x, y, n_obs, raw, cands.reshape(nb, B, D), np.ones((nb, B)), 1e-6)[0]

    dense = scores(n_cand)
    i_dense = int(np.argmax(dense))
    med = {}
    for B in (256, 512):
        bl = scores(B)
        med[B] = float(np.median(np.abs(bl - dense) / np.abs(dense)))
        regret = (dense[i_dense] - dense[int(np.argmax(bl))]) / dense[i_dense]
        assert regret < 0.03, (B, regret)
    assert med[512] < 0.08
    assert med[512] < med[256]


def _run_design(pkg, cls, seed=42, **kw):
    np.random.seed(seed)
    ed = pkg.LatinHypercubeDesign([(0.0, 1.0), (0.0, 1.0)])

    def f(x):
        return np.sin(4 * x[0]) + x[1] ** 2

    if pkg is mogp_tpu_torch:
        kw = dict(kw, device="cpu")
    md = getattr(pkg, cls)(ed, f, n_samples=4, n_init=6, n_cand=16, **kw)
    md.run_sequential_design()
    return md


@pytest.fixture(scope="module")
def jax_device_design():
    return _run_design(mogp_tpu, "DeviceMICEDesign", n_tries=4, maxiter=50)


def test_device_mice_full_loop_matches_mogp_tpu_with_fixed_shapes(monkeypatch, jax_device_design):
    """Seed 42: the same chosen inputs, targets, last theta and scores as
    mogp_tpu's loop; every step hands the fit and the score step the same
    shapes (the port's form of the JAX package's two-programs test)."""
    shapes = {"fit": set(), "score": set()}
    fit, score = tmd._mice_fit_step, tmd._mice_score_step

    def fit_spy(starts, data, mask, *a):
        shapes["fit"].add((tuple(starts.shape), tuple(data.inputs.shape), tuple(mask.shape)))
        return fit(starts, data, mask, *a)

    def score_spy(raw, data, mask, blocks, cmask, *a):
        shapes["score"].add((tuple(data.inputs.shape), tuple(mask.shape), tuple(blocks.shape),
                             tuple(cmask.shape)))
        return score(raw, data, mask, blocks, cmask, *a)

    monkeypatch.setattr(tmd, "_mice_fit_step", fit_spy)
    monkeypatch.setattr(tmd, "_mice_score_step", score_spy)
    md = _run_design(mogp_tpu_torch, "DeviceMICEDesign", n_tries=4, maxiter=50)
    assert md.inputs.shape == (10, 2) and md.targets.shape == (10,)
    assert np.all(np.isfinite(md.targets))
    assert shapes == {"fit": {((4, 3), (1, 10, 2), (10,))},
                      "score": {((1, 10, 2), (10,), (1, 16, 2), (1, 16))}}
    ref = jax_device_design
    assert_allclose(md.inputs, ref.inputs, rtol=0, atol=0)
    assert_allclose(md.targets, ref.targets, rtol=1e-15)
    assert_allclose(md.get_current_theta(), ref.get_current_theta(), rtol=1e-8)
    assert_allclose(md._last_scores, ref._last_scores, rtol=RTOL_SCORES)


def test_device_mice_uniform_kernel():
    """Uniform-form kernels have one correlation slot; the per-step priors
    size to the kernel."""
    md = _run_design(mogp_tpu_torch, "DeviceMICEDesign", n_tries=4, maxiter=50,
                     kernel="UniformSqExp")
    assert md.inputs.shape == (10, 2)
    assert np.all(np.isfinite(md.targets))
    assert md.get_current_theta().shape == (2,)


def test_device_mice_design_quality_parity():
    """The device design's fill distance within a small factor of the
    host MICEDesign's on the same problem."""

    def fill_distance(pts, grid):
        return np.linalg.norm(grid[:, None, :] - pts[None, :, :], axis=-1).min(axis=1).max()

    grid = np.stack(np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21)), -1).reshape(-1, 2)
    md_dev = _run_design(mogp_tpu_torch, "DeviceMICEDesign", n_tries=4, maxiter=50)
    md_host = _run_design(mogp_tpu_torch, "MICEDesign")
    assert fill_distance(md_dev.inputs, grid) < 1.5 * fill_distance(md_host.inputs, grid) + 0.05


def test_device_mice_blocked_candidates_match_mogp_tpu():
    """Block-local candidate LOO (cand_block < n_cand) scores finite and
    chooses mogp_tpu's points."""
    md = _run_design(mogp_tpu_torch, "DeviceMICEDesign", n_tries=4, maxiter=50, cand_block=8)
    assert md.inputs.shape == (10, 2)
    assert np.all(np.isfinite(md._last_scores))
    ref = _run_design(mogp_tpu, "DeviceMICEDesign", n_tries=4, maxiter=50, cand_block=8)
    assert_allclose(md.inputs, ref.inputs, rtol=0, atol=0)


def test_device_mice_batch_points():
    np.random.seed(7)
    ed = mogp_tpu_torch.LatinHypercubeDesign([(0.0, 1.0), (0.0, 1.0)])
    md = mogp_tpu_torch.DeviceMICEDesign(ed, n_samples=6, n_init=5, n_cand=12, n_tries=4,
                                         maxiter=50, device="cpu")
    md.generate_initial_design()
    md.set_initial_targets([np.sin(4 * p[0]) + p[1] ** 2 for p in md.inputs])
    batch = md.get_batch_points(3)
    assert batch.shape == (3, 2)
    assert np.all((batch >= 0) & (batch <= 1))


def test_device_mice_narrowed_contracts():
    """The cached mean serves only the last chosen point; a design grown
    past n_max raises."""
    np.random.seed(8)
    ed = mogp_tpu_torch.LatinHypercubeDesign([(0.0, 1.0), (0.0, 1.0)])
    md = mogp_tpu_torch.DeviceMICEDesign(ed, n_init=5, n_cand=12, n_max=6, n_tries=4,
                                         maxiter=30, device="cpu")
    md.generate_initial_design()
    md.set_initial_targets([np.sin(4 * p[0]) + p[1] ** 2 for p in md.inputs])
    pt = md.get_next_point()
    est = md._estimate_next_target(pt)
    assert est.shape == (1,) and np.isfinite(est).all()
    assert_allclose(est, md._last_mu[md._last_index] * md._t_std + md._t_mean, rtol=1e-15)
    with pytest.raises(ValueError, match="last get_next_point"):
        md._estimate_next_target(pt + 0.1)
    md.set_next_target(est)
    md.get_next_point()  # 6 observed rows fill n_max
    md.set_next_target(0.0)
    with pytest.raises(RuntimeError, match="n_max"):
        md.get_next_point()


def test_device_mice_fit_escalates_to_the_full_ladder(monkeypatch):
    """Draws whose every restart failed draw again; under "adaptive" the
    fourth and later draws run the full jitter ladder; ten failed draws
    raise."""
    ladders = []

    def failing(starts, data, mask, kernel, nugget_type, weak, maxiter, gtol, ftol, ladder):
        ladders.append(ladder)
        return torch.full((starts.shape[0],), float("nan"), dtype=starts.dtype), starts

    monkeypatch.setattr(tmd, "_mice_fit_step", failing)
    np.random.seed(9)
    ed = mogp_tpu_torch.LatinHypercubeDesign(2)
    md = mogp_tpu_torch.DeviceMICEDesign(ed, n_samples=2, n_init=5, n_cand=8, n_tries=3,
                                         device="cpu")
    md.generate_initial_design()
    md.set_initial_targets(np.arange(5.0))
    with pytest.raises(RuntimeError, match="Unable to find parameters"):
        md.get_next_point()
    assert ladders == ["single"] * 3 + [False] * 7


def test_device_mice_requires_n_max():
    ed = mogp_tpu_torch.LatinHypercubeDesign([(0.0, 1.0)])
    with pytest.raises(ValueError):
        mogp_tpu_torch.DeviceMICEDesign(ed, n_samples=None, n_init=4, device="cpu")
    md = mogp_tpu_torch.DeviceMICEDesign(ed, n_samples=None, n_init=4, n_max=9, device="cpu")
    assert md.n_max == 9


def test_device_mice_rejects_pivot_nugget():
    ed = mogp_tpu_torch.LatinHypercubeDesign([(0.0, 1.0)])
    with pytest.raises(ValueError, match="pivot"):
        mogp_tpu_torch.DeviceMICEDesign(ed, n_samples=2, n_init=4, nugget="pivot", device="cpu")


def test_device_mice_mesh_is_refused():
    """A ``mesh`` that is not a ``parallel.DeviceMesh`` raises ``TypeError``
    instead of scoring on one device."""
    ed = mogp_tpu_torch.LatinHypercubeDesign([(0.0, 1.0)])
    with pytest.raises(TypeError, match="mesh"):
        mogp_tpu_torch.DeviceMICEDesign(ed, n_samples=2, n_init=4, mesh=object(), device="cpu")
