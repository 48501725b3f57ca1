"""One-shot experimental designs of the port against ``mogp_tpu``.

Both packages draw from numpy's global RNG in the same order, so a seeded
design is the same array in both: Monte Carlo, Latin hypercube and
MaxiMin (whose candidates the port scores with torch, here on the CPU in
float64).  The argument forms, PPFs and failures of
``tests/test_experimental_design.py`` are run through both packages.
"""

import numpy as np
import pytest
import scipy.stats

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402
from mogp_tpu.uq import experimental_design as jed  # noqa: E402
from mogp_tpu_torch.uq import experimental_design as ted  # noqa: E402

torch.set_num_threads(2)

NAMES = ("MonteCarloDesign", "LatinHypercubeDesign", "MaxiMinLHC")
SPECS = [
    (3,),
    (2, (-2.0, 6.0)),
    (2, scipy.stats.norm(loc=1.0, scale=2.0).ppf),
    ([(0.0, 1.0), scipy.stats.expon().ppf, None],),
    (2, [(0.0, 2.0), (5.0, 9.0)]),
]


def _design(pkg, name, *args):
    kw = {"device": "cpu"} if pkg is mogp_tpu_torch else {}
    return getattr(pkg, name)(*args, **kw)


def _seeded(pkg, name, args, seed, n, **kw):
    np.random.seed(seed)
    return _design(pkg, name, *args).sample(n, **kw)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_seeded_designs_are_the_same_array(name, spec):
    kw = {"n_tries": 50} if name == "MaxiMinLHC" else {}
    a = _seeded(mogp_tpu, name, SPECS[spec], 100 + spec, 17, **kw)
    b = _seeded(mogp_tpu_torch, name, SPECS[spec], 100 + spec, 17, **kw)
    assert_array_equal(b, a)
    # the RNG is left where mogp_tpu leaves it
    np.random.seed(7)
    _design(mogp_tpu, name, *SPECS[spec]).sample(5, **kw)
    after_j = np.random.random()
    np.random.seed(7)
    _design(mogp_tpu_torch, name, *SPECS[spec]).sample(5, **kw)
    assert np.random.random() == after_j


def test_maximin_at_the_headline_shape():
    """14 parameters, 210 samples, 300 tries: the same design, and the
    port's scores equal mogp_tpu's min pairwise distances."""
    a = _seeded(mogp_tpu, "MaxiMinLHC", (14,), 0, 210, n_tries=300)
    b = _seeded(mogp_tpu_torch, "MaxiMinLHC", (14,), 0, 210, n_tries=300)
    assert_array_equal(b, a)
    rng = np.random.RandomState(1)
    cands = rng.rand(40, 60, 5)
    ref = np.asarray(jed._min_pdist_batch(cands))
    got = ted.MaxiMinLHC._score_candidates(cands, "cpu")
    assert_allclose(got, ref, rtol=1e-12)
    got_t = ted._min_pdist_batch(torch.tensor(cands)).numpy()
    assert_allclose(got_t, ref, rtol=1e-12)


def test_score_chunks_bound_the_distances(monkeypatch):
    """Candidates are scored in chunks of at most 2^26 distance elements:
    with 3000 tries of 200 samples, two chunks, the same scores as one."""
    calls = []
    real = ted._min_pdist_batch

    def spy(block):
        calls.append(block.shape)
        return real(block)

    monkeypatch.setattr(ted, "_min_pdist_batch", spy)
    cands = np.random.RandomState(2).rand(3000, 200, 2)
    got = ted.MaxiMinLHC._score_candidates(cands, "cpu")
    assert [c[0] for c in calls] == [1677, 1323]
    assert all(c[0] * 200 * 200 <= 1 << 26 for c in calls)
    assert_allclose(got[:5], real(torch.tensor(cands[:5])).numpy(), rtol=0)


@pytest.mark.parametrize("pkg", [mogp_tpu, mogp_tpu_torch], ids=["jax", "torch"])
def test_argument_forms_and_failures(pkg):
    """The constructor surface of tests/test_experimental_design.py."""
    ed = _design(pkg, "MonteCarloDesign", 3, (-2.0, 6.0))
    assert ed.get_n_parameters() == 3
    assert ed.distributions[0](0.0) == pytest.approx(-2.0)
    assert ed.distributions[0](1.0) == pytest.approx(6.0)
    ed = _design(pkg, "MonteCarloDesign", [scipy.stats.lognorm(s=0.5).ppf, None])
    u = np.linspace(0.05, 0.95, 7)
    assert_allclose(ed.distributions[0](u), scipy.stats.lognorm(s=0.5).ppf(u), rtol=1e-12)
    for args, exc in [((), ValueError), ((3, (0.0, 1.0), "extra"), ValueError), ((0,), ValueError),
                      ((-2,), ValueError), (("three",), TypeError),
                      ((3, [(0.0, 1.0), (0.0, 1.0)]), ValueError), ((2, 7.5), TypeError),
                      ((2, (1.0, 0.0)), ValueError)]:
        with pytest.raises(exc):
            _design(pkg, "MonteCarloDesign" if args else "ExperimentalDesign", *args)
    with pytest.raises(ValueError):
        _design(pkg, "MonteCarloDesign", 1, lambda a, b: a)
    base = _design(pkg, "ExperimentalDesign", 2)
    with pytest.raises(NotImplementedError):
        base.get_method()
    with pytest.raises(NotImplementedError):
        base.sample(3)
    assert str(base) == "Experimental Design with 2 parameters"
    assert str(_design(pkg, "LatinHypercubeDesign", 3)) == (
        "Latin Hypercube Experimental Design with 3 parameters")
    assert _design(pkg, "MaxiMinLHC", 2).get_method() == "MaxiMinLHC"
    with pytest.raises(AssertionError):
        _design(pkg, "MonteCarloDesign", 2).sample(0)
    with pytest.raises(AssertionError):
        _design(pkg, "MonteCarloDesign", 1, lambda u: np.inf).sample(3)
    with pytest.raises(AssertionError):
        _design(pkg, "MaxiMinLHC", 2).sample(4, n_tries=0)


def test_lhc_strata_and_scalar_ppf():
    """A PPF that takes scalars only is applied element by element; the
    LHC keeps one sample per stratum in both packages."""
    def scalar_ppf(u):
        return float(scipy.stats.norm.ppf(float(u)))

    a = _seeded(mogp_tpu, "LatinHypercubeDesign", (2, scalar_ppf), 61, 16)
    b = _seeded(mogp_tpu_torch, "LatinHypercubeDesign", (2, scalar_ppf), 61, 16)
    assert_array_equal(b, a)
    strata = np.floor(scipy.stats.norm.cdf(b) * 16).astype(int)
    for j in range(2):
        assert sorted(strata[:, j]) == list(range(16))


def test_design_defaults_to_the_card(monkeypatch):
    """MaxiMin scores on the card unless asked for the CPU: with no card
    the default raises and does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mm = mogp_tpu_torch.MaxiMinLHC(2)
    with pytest.raises(RuntimeError, match="cuda"):
        mm.sample(5, n_tries=3)
    assert mogp_tpu_torch.MonteCarloDesign(2).sample(4).shape == (4, 2)
