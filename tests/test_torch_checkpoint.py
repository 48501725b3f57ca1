"""Checkpoints and the batched fit of a ``MultiOutputGP`` in the port.

Three faults of ``mogp_tpu_torch`` against what a user expects of a
checkpoint, each held here in float64 on the CPU:

* a standardized GP or ``MultiOutputGP`` comes back standardized, so its
  predictions and log posterior survive the round trip (``mogp_tpu``
  stores no ``standardize`` and does not);
* a path saved without ``.npz`` loads by the same path;
* ``MultiOutputGP.fit`` (and so ``load_mogp`` and the MAP refit) runs in
  chunks of at most ``fitting._max_lanes`` lanes, on the progressive
  jitter ladder at n >= ``PROGRESSIVE_LADDER_MIN_N``, and agrees with a
  fit of each emulator on its own.
"""

import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import fitting  # noqa: E402
from mogp_tpu_torch.models import mogp as tmogp  # noqa: E402
from mogp_tpu_torch.ops import cholesky as tchol  # noqa: E402
from mogp_tpu_torch.utils.checkpoint import (  # noqa: E402
    atomic_savez, load_gp, load_mogp, save_gp, save_mogp,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)


def _data(n=30, d=2, n_out=1, seed=3):
    r = np.random.RandomState(seed)
    x = r.uniform(size=(n, d))
    y = np.stack([16.0 * np.sin(6 * x[:, 0] + k) + 8.0 * x[:, 1] + 20.0 * k
                  for k in range(n_out)])
    return x, y


def _same_gp(a, b, q):
    ra, rb = a.predict(q), b.predict(q)
    assert_allclose(rb.mean, ra.mean, **TOL)
    assert_allclose(rb.unc, ra.unc, **TOL)
    assert_allclose(b.current_logpost, a.current_logpost, **TOL)


def test_standardized_gp_survives_a_checkpoint(tmp_path):
    x, y = _data()
    assert 8.0 < np.std(y[0]) < 12.0
    gp = mogp_tpu_torch.GaussianProcess(x, y[0], standardize=True, device="cpu")
    gp.fit(np.array([0.2, -0.4, 0.3]))
    save_gp(gp, tmp_path / "gp.npz")
    back = load_gp(tmp_path / "gp.npz", device="cpu")
    assert back._standardize
    _same_gp(gp, back, np.random.RandomState(1).uniform(size=(7, 2)))


def test_standardized_mogp_survives_a_checkpoint(tmp_path):
    x, y = _data(n_out=3)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, standardize=[True, False, True], device="cpu")
    mgp.fit(np.array([[0.2, -0.4, 0.3], [0.1, 0.0, 0.5], [-0.3, 0.2, 0.1]]))
    q = np.random.RandomState(2).uniform(size=(6, 2))
    # the batched predict maps each standardized lane back to its targets
    res = mgp.predict(q)
    for em, mu, var in zip(mgp.emulators, res.mean, res.unc):
        r = em.predict(q)
        assert_allclose(mu, r.mean, **TOL)
        assert_allclose(var, r.unc, **TOL)
    save_mogp(mgp, tmp_path / "mgp.npz")
    back = load_mogp(tmp_path / "mgp.npz", device="cpu")
    assert [em._standardize for em in back.emulators] == [True, False, True]
    ra, rb = mgp.predict(q), back.predict(q)
    assert_allclose(rb.mean, ra.mean, **TOL)
    assert_allclose(rb.unc, ra.unc, **TOL)
    for a, b in zip(mgp.emulators, back.emulators):
        assert_allclose(b.current_logpost, a.current_logpost, **TOL)


def test_checkpoint_without_the_key_loads_unstandardized(tmp_path):
    """A file written before ``standardize`` was stored."""
    x, y = _data()
    gp = mogp_tpu_torch.GaussianProcess(x, y[0], device="cpu")
    gp.fit(np.array([0.2, -0.4, 0.3]))
    config = {"mean": None, "kernel": "SquaredExponential", "nugget": "adaptive"}
    atomic_savez(tmp_path / "old.npz", inputs=x, targets=y[0], config=json.dumps(config),
                 theta=gp.theta.get_data())
    back = load_gp(tmp_path / "old.npz", device="cpu")
    assert not back._standardize
    _same_gp(gp, back, x[:5] + 0.01)


def test_paths_without_the_extension_load(tmp_path):
    x, y = _data(n_out=2)
    gp = mogp_tpu_torch.GaussianProcess(x, y[0], device="cpu")
    gp.fit(np.array([0.2, -0.4, 0.3]))
    save_gp(gp, tmp_path / "ckpt")
    assert os.path.exists(tmp_path / "ckpt.npz")
    _same_gp(gp, load_gp(tmp_path / "ckpt", device="cpu"), x[:4])
    _same_gp(gp, load_gp(str(tmp_path / "ckpt"), device="cpu"), x[:4])

    mgp = mogp_tpu_torch.MultiOutputGP(x, y, device="cpu")
    mgp.fit(np.zeros((2, 3)))
    save_mogp(mgp, tmp_path / "mckpt")
    back = load_mogp(tmp_path / "mckpt", device="cpu")
    assert_allclose(back.predict(x[:4]).mean, mgp.predict(x[:4]).mean, **TOL)

    # a file that exists under the exact path given opens as it is
    os.replace(tmp_path / "ckpt.npz", tmp_path / "bare")
    _same_gp(gp, load_gp(tmp_path / "bare", device="cpu"), x[:4])


def test_inference_checkpoints_resolve_extension_less_paths(tmp_path):
    """``save_mcmc`` / ``load_mcmc``, ``load_tagged`` and
    ``remove_checkpoint`` name an extension-less path's file as
    ``np.savez`` writes it; ``mogp_tpu``'s ``load_tagged`` checks the path
    as given and so never resumes one."""
    from mogp_tpu_torch.models.inference import MCMCResult
    from mogp_tpu_torch.utils import checkpoint as ck

    rng = np.random.RandomState(0)
    res = MCMCResult(rng.randn(2, 5, 3), rng.rand(2, 5), rng.rand(2, 5) < 0.2, rng.rand(3),
                     rng.rand(3))
    ck.save_mcmc(res, tmp_path / "mcmc")
    back = ck.load_mcmc(tmp_path / "mcmc")
    for a, b in zip(res, back):
        np.testing.assert_array_equal(a, b)

    ck.atomic_savez(tmp_path / "run", tag=np.asarray("t1"), x=np.arange(3))
    assert ck.load_tagged(tmp_path / "run", None, "NUTS")["x"].tolist() == [0, 1, 2]
    assert ck.load_tagged(str(tmp_path / "run"), "t1", "NUTS") is not None
    with pytest.warns(UserWarning, match="different run"):
        assert ck.load_tagged(tmp_path / "run", "t2", "NUTS") is None
    assert ck.load_tagged(tmp_path / "absent", "t1", "NUTS") is None
    ck.remove_checkpoint(tmp_path / "run")
    assert not os.path.exists(tmp_path / "run.npz")
    ck.remove_checkpoint(tmp_path / "run")   # absent: nothing to do


@pytest.fixture
def gp_fit_calls(monkeypatch):
    """Every ``gp_fit`` call of ``MultiOutputGP``: (lanes, progressive_ok)."""
    calls = []
    real = tmogp.gp_fit

    def spy(*args, **kwargs):
        bound = inspect.signature(real).bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append((bound.arguments["raw"].shape[0], bound.arguments["progressive_ok"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tmogp, "gp_fit", spy)
    return calls


def _shrink_chunks(monkeypatch, n, lanes):
    monkeypatch.setattr(fitting, "_CHUNK_BYTES", lanes * fitting._LANE_MATRICES * n * n * 8)


def test_large_n_mogp_fit_is_chunked_and_progressive(monkeypatch, gp_fit_calls, tmp_path):
    n = tchol.PROGRESSIVE_LADDER_MIN_N
    x, y = _data(n=n, n_out=5, seed=4)
    thetas = np.array([[0.5, -0.2, 0.1], [0.3, 0.3, 0.0], [1.5, 1.5, 0.2],
                       [-0.1, 0.4, -0.3], [0.2, 0.2, 0.2]])
    _shrink_chunks(monkeypatch, n, 2)
    mgp = mogp_tpu_torch.MultiOutputGP(x, y, device="cpu")
    assert fitting._max_lanes(mgp.emulators[0]) == 2
    mgp.fit(thetas)
    assert [c[0] for c in gp_fit_calls] == [2, 2, 1]
    assert all(progressive for _, progressive in gp_fit_calls)

    q = np.random.RandomState(5).uniform(size=(5, 2))
    res = mgp.predict(q)
    for k, em in enumerate(mgp.emulators):
        alone = mogp_tpu_torch.GaussianProcess(x, y[k], device="cpu")
        alone.fit(thetas[k])
        assert_allclose(em.nugget, alone.nugget, **TOL)
        assert_allclose(em.current_logpost, alone.current_logpost, **TOL)
        r = alone.predict(q)
        assert_allclose(res.mean[k], r.mean, **TOL)
        assert_allclose(res.unc[k], r.unc, **TOL)

    # load_mogp goes through the same chunks
    save_mogp(mgp, tmp_path / "big")
    del gp_fit_calls[:]
    load_mogp(tmp_path / "big", device="cpu")
    assert [c[0] for c in gp_fit_calls] == [2, 2, 1]


def test_map_refit_goes_through_the_chunked_fit(monkeypatch, gp_fit_calls):
    x, y = _data(n=20, n_out=3)
    _shrink_chunks(monkeypatch, 20, 1)
    np.random.seed(2)
    mgp = mogp_tpu_torch.fit_GP_MAP(mogp_tpu_torch.MultiOutputGP(x, y, device="cpu"),
                                    n_tries=2, maxiter=20)
    assert len(mgp.get_indices_fit()) == 3
    assert [c[0] for c in gp_fit_calls] == [1, 1, 1]
