"""Segments and checkpoints of the port's NUTS runs: segments of any
length and a run resumed from its checkpoint equal the run in one piece,
bit for bit (the same transitions, adaptation state and counter-based
draws); a checkpoint of another run is ignored; an extension-less path
resumes (``mogp_tpu`` looks for the path as given, which ``np.savez``
never wrote)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402

torch.set_num_threads(2)


def _small_gp(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, size=(n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] if n > 12 else np.sin(2 * x[:, 0])
    np.random.seed(0)
    return mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cpu"), n_tries=2,
        maxiter=40 if n > 12 else 30)


def test_segmented_nuts_matches_single_run():
    """Segments of any length compose to the run in one piece, bit for bit
    (the same transitions, adaptation state and counter-based draws)."""
    gp = _small_gp(8, 15)
    kw = dict(n_samples=40, n_warmup=30, n_chains=2, seed=5, theta0=gp.theta.get_data())
    res_one = tinf.sample_GP_MCMC(gp, **kw)
    res_seg = tinf.sample_GP_MCMC(gp, segment=16, **kw)
    np.testing.assert_array_equal(res_seg.samples, res_one.samples)
    np.testing.assert_array_equal(res_seg.accept_prob, res_one.accept_prob)
    np.testing.assert_array_equal(res_seg.diverging, res_one.diverging)


def test_nuts_checkpoint_tag_mismatch(tmp_path):
    """A checkpoint from another configuration is ignored (a fresh start
    with a warning), not resumed."""
    gp = _small_gp(13, 12)
    ckpt = tmp_path / "c.npz"
    kw = dict(n_chains=2, seed=1, theta0=gp.theta.get_data(), segment=4)
    ref = tinf.sample_GP_MCMC(gp, n_samples=8, n_warmup=4, checkpoint_path=str(ckpt), **kw)
    assert not ckpt.exists()
    # a stale checkpoint with a wrong tag
    np.savez(str(ckpt), tag=np.asarray("bogus"), phase=np.asarray(1), idx=np.asarray(4))
    with pytest.warns(UserWarning, match="different run"):
        res = tinf.sample_GP_MCMC(gp, n_samples=8, n_warmup=4, checkpoint_path=str(ckpt), **kw)
    assert np.all(np.isfinite(res.samples))
    np.testing.assert_array_equal(res.samples, ref.samples)


@pytest.mark.parametrize("name", ["chain.npz", "chain"])
def test_nuts_checkpoint_resume(tmp_path, monkeypatch, name):
    """A preempted segmented run resumes from its checkpoint and yields the
    uninterrupted chains bit for bit (state and stream position are
    saved), from a path with or without ``.npz``."""
    rng = np.random.RandomState(12)
    x = rng.uniform(0, 1, size=(15, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    np.random.seed(0)
    gp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.GaussianProcess(x, y, nugget="fit", device="cpu"), n_tries=2, maxiter=40)
    kw = dict(n_samples=32, n_warmup=16, n_chains=2, seed=5, theta0=gp.theta.get_data(),
              segment=8)
    ref = tinf.sample_GP_MCMC(gp, **kw)

    ckpt = tmp_path / name
    written = tmp_path / "chain.npz"
    orig = tinf._nuts_sample_seg
    calls = {"n": 0}

    def preempt(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("preempted")
        return orig(*a, **k)

    monkeypatch.setattr(tinf, "_nuts_sample_seg", preempt)
    with pytest.raises(RuntimeError, match="preempted"):
        tinf.sample_GP_MCMC(gp, checkpoint_path=str(ckpt), **kw)
    monkeypatch.setattr(tinf, "_nuts_sample_seg", orig)
    assert written.exists()  # one sampling segment persisted
    assert int(np.load(str(written))["phase"]) == 1

    resumed = {"n": 0}

    def count(*a, **k):
        resumed["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tinf, "_nuts_sample_seg", count)
    res = tinf.sample_GP_MCMC(gp, checkpoint_path=str(ckpt), **kw)
    assert resumed["n"] == 3   # the three segments left, not four
    assert not written.exists()  # removed on completion
    np.testing.assert_array_equal(res.samples, ref.samples)
    np.testing.assert_array_equal(res.accept_prob, ref.accept_prob)
