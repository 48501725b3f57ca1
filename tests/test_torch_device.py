"""The port's default device is the card: every entry point that is not
given ``device=`` runs on CUDA, and raises when there is none, rather than
carrying on on the CPU (``tests/test_torch_no_jax.py`` checks the default
itself).  Whether a card is there is patched inside each test, never
decided at import time."""

import numpy as np
import pytest
import torch

import mogp_tpu_torch
from mogp_tpu_torch import config
from mogp_tpu_torch.models.gp import make_gp_data
from mogp_tpu_torch.utils.checkpoint import save_gp, save_mogp

X = np.random.RandomState(0).rand(12, 2)
Y = np.stack([np.sin(3 * X[:, 0]) + X[:, 1], X[:, 0] - X[:, 1]])


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: config.resolve_device(None),
    lambda: config.default_dtype(None),
    lambda: mogp_tpu_torch.GaussianProcess(X, Y[0]),
    lambda: mogp_tpu_torch.MultiOutputGP(X, Y),
    lambda: mogp_tpu_torch.fit_GP_MAP(X, Y[0], n_tries=1, maxiter=2),
    lambda: mogp_tpu_torch.fit_GP_MAP(X, Y, n_tries=1, maxiter=2),
    lambda: make_gp_data(X, Y[0], np.ones((len(X), 1)), None),
    lambda: mogp_tpu_torch.SequentialDesign(mogp_tpu_torch.LatinHypercubeDesign(2)),
    lambda: mogp_tpu_torch.MICEDesign(mogp_tpu_torch.LatinHypercubeDesign(2)),
    lambda: mogp_tpu_torch.MICEFastGP(X, np.ones(len(X)), nugget=1e-3),
    lambda: mogp_tpu_torch.DeviceMICEDesign(mogp_tpu_torch.LatinHypercubeDesign(2), n_samples=2),
], ids=["resolve_device", "default_dtype", "GaussianProcess", "MultiOutputGP",
        "fit_GP_MAP_single", "fit_GP_MAP_multi", "make_gp_data", "SequentialDesign",
        "MICEDesign", "MICEFastGP", "DeviceMICEDesign"])
def test_no_card_raises_without_a_device(no_card, entry):
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


def test_checkpoints_load_onto_the_card_by_default(no_card, tmp_path):
    gp = mogp_tpu_torch.GaussianProcess(X, Y[0], device="cpu")
    gp.fit(np.zeros(gp.n_params))
    mgp = mogp_tpu_torch.MultiOutputGP(X, Y, device="cpu")
    gpath, mpath = str(tmp_path / "gp.npz"), str(tmp_path / "mogp.npz")
    save_gp(gp, gpath)
    save_mogp(mgp, mpath)
    with pytest.raises(RuntimeError, match="cuda"):
        mogp_tpu_torch.load_gp(gpath)
    with pytest.raises(RuntimeError, match="cuda"):
        mogp_tpu_torch.load_mogp(mpath)
    assert mogp_tpu_torch.load_gp(gpath, device="cpu").current_logpost == gp.current_logpost
