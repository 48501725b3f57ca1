"""Checkpoints for emulators, in the ``.npz`` format of ``mogp_tpu``.

Port of ``mogp_tpu/utils/checkpoint.py:40-151``.  The files are the same
in both packages, which is how fitted emulators cross over: a file written
by ``mogp_tpu.utils.checkpoint.save_mogp`` loads here with
``load_mogp(path, device=...)`` and gives the same emulator.  Loading
re-fits the device artifacts from the stored hyperparameters.
"""

import json
import os

import numpy as np

from ..models.gp import GaussianProcess
from ..models.mogp import MultiOutputGP

__all__ = ["atomic_savez", "save_gp", "load_gp", "save_mogp", "load_mogp"]


def _npz_path(path):
    """The file ``np.savez`` writes for ``path``: ``.npz`` is appended
    when missing."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def atomic_savez(path, **payload):
    """Atomic ``.npz`` write: temp file + ``os.replace``.  A missing
    ``.npz`` extension is appended, as ``np.savez`` does."""
    path = _npz_path(path)
    tmp = "{}.tmp.npz".format(path)
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_npz(path):
    """Open a checkpoint by the rule ``atomic_savez`` writes it under: a
    path that exists as given opens as it is, any other one with
    ``.npz`` appended (``mogp_tpu`` opens only the path as given)."""
    path = str(path)
    return np.load(path if os.path.exists(path) else _npz_path(path), allow_pickle=False)


def _gp_config(gp):
    return {
        "mean": gp._mean,
        "kernel": type(gp.kernel).__name__,
        "nugget": (
            gp._nugget_value if gp.nugget_type == "fixed" else gp.nugget_type
        ),
        # mogp_tpu stores no "standardize", so its standardized GPs come back
        # fit on the raw targets; files without the key load unstandardized
        "standardize": gp._standardize,
    }


def save_gp(gp, filename):
    """Checkpoint a single-output GP to ``.npz``.

    Custom priors are not serialized (defaults are rebuilt from the data on
    load); hyperparameters and the fit state are preserved.
    """
    theta = gp.theta.get_data()
    atomic_savez(
        filename,
        inputs=np.asarray(gp.inputs),
        targets=np.asarray(gp.targets),
        config=json.dumps(_gp_config(gp)),
        theta=(np.array([]) if theta is None else np.asarray(theta)),
    )


def load_gp(filename, device=None, dtype=None):
    """Restore a GP checkpoint onto ``device``; re-fits if it was fit."""
    f = _load_npz(filename)
    config = json.loads(str(f["config"]))
    gp = GaussianProcess(
        f["inputs"],
        f["targets"],
        mean=config["mean"],
        kernel=config["kernel"],
        nugget=config["nugget"],
        standardize=config.get("standardize", False),
        device=device,
        dtype=dtype,
    )
    theta = f["theta"]
    if theta.size > 0:
        gp.fit(theta)
    return gp


def save_mogp(mgp, filename):
    """Checkpoint a MultiOutputGP (homogeneous or heterogeneous configs)."""
    configs = [json.dumps(_gp_config(em)) for em in mgp.emulators]
    thetas = [
        (np.array([]) if em.theta.get_data() is None else np.asarray(em.theta.get_data()))
        for em in mgp.emulators
    ]
    atomic_savez(
        filename,
        inputs=np.asarray(mgp.inputs),
        targets=np.asarray(mgp.targets),
        configs=np.asarray(configs),  # fixed-width unicode
        **{"theta_{}".format(i): t for i, t in enumerate(thetas)},
    )


def load_mogp(filename, device=None, dtype=None):
    """Restore a MultiOutputGP checkpoint onto ``device``; the fitted
    emulators are re-fit as ``MultiOutputGP.fit`` fits them."""
    f = _load_npz(filename)
    configs = [json.loads(str(c)) for c in f["configs"]]
    mgp = MultiOutputGP(
        f["inputs"],
        f["targets"],
        mean=[c["mean"] for c in configs],
        kernel=[c["kernel"] for c in configs],
        nugget=[c["nugget"] for c in configs],
        standardize=[c.get("standardize", False) for c in configs],
        device=device,
        dtype=dtype,
    )
    thetas = [f["theta_{}".format(i)] for i in range(mgp.n_emulators)]
    fitted = [i for i, theta in enumerate(thetas) if theta.size > 0]
    mgp._fit_lanes(fitted, [thetas[i] for i in fitted])
    return mgp
