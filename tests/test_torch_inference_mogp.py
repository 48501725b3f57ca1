"""The port's ``sample_MOGP_MCMC``: the statistical port of
``tests/test_inference.py::test_sample_mogp_mcmc`` (same data, seeds and
assertions; the random streams are the port's own)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import mogp_tpu_torch  # noqa: E402
from mogp_tpu_torch.models import inference as tinf  # noqa: E402

torch.set_num_threads(2)


def test_sample_mogp_mcmc():
    np.random.seed(9)
    x = np.random.rand(30, 2) * 2
    ys = np.stack([np.sin(3 * x[:, 0]) * x[:, 1], np.cos(3 * x[:, 0]) + x[:, 1]])
    mgp = mogp_tpu_torch.fit_GP_MAP(
        mogp_tpu_torch.MultiOutputGP(x, ys, nugget="fit", device="cpu"), n_tries=4)
    results = tinf.sample_MOGP_MCMC(mgp, n_samples=80, n_warmup=120, n_chains=2, seed=0)
    assert len(results) == 2
    for res, em in zip(results, mgp.emulators):
        assert res.samples.shape == (2, 80, em.n_params)
        assert np.all(np.isfinite(res.samples))
        # chains mix (weakly-identified GP posteriors can be multimodal, so
        # proximity to the MAP is not asserted; mixing is)
        assert np.all(res.rhat < 1.3)
        assert res.accept_prob.mean() > 0.5
