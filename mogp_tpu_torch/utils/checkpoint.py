"""Checkpoints for emulators and long-running inference, in the ``.npz``
format of ``mogp_tpu``.

Port of ``mogp_tpu/utils/checkpoint.py``.  The emulator files are the same
in both packages, which is how fitted emulators cross over: a file written
by ``mogp_tpu.utils.checkpoint.save_mogp`` loads here with
``load_mogp(path, device=...)`` and gives the same emulator.  Loading
re-fits the device artifacts from the stored hyperparameters.

``save_mcmc`` / ``load_mcmc`` keep an ``MCMCResult``; ``save_smc`` /
``load_smc`` an SMC anneal's state after a stage, which
``smc_history_match(checkpoint_path=...)`` resumes from, and
``load_tagged`` opens the tag-guarded files of both samplers.  Every
loader opens a path by the rule the writers use (``.npz`` appended when
missing), so an extension-less ``checkpoint_path`` resumes; ``mogp_tpu``
checks only the path as given and never resumes one.
"""

import hashlib
import json
import os
import warnings

import numpy as np
import torch

__all__ = [
    "atomic_savez",
    "config_tag",
    "load_tagged",
    "remove_checkpoint",
    "save_gp",
    "load_gp",
    "save_mogp",
    "load_mogp",
    "save_mcmc",
    "load_mcmc",
    "save_smc",
    "load_smc",
]


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
    """Open an emulator checkpoint by the rule ``atomic_savez`` writes it
    under: a path that exists as given opens as it is, any other one with
    ``.npz`` appended (``mogp_tpu`` opens only the path as given)."""
    path = str(path)
    return np.load(path if os.path.exists(path) else _npz_path(path), allow_pickle=False)


def load_tagged(path, tag, what):
    """Load a tag-guarded ``.npz`` checkpoint (an inference run's state).

    Returns the open archive, or ``None`` when the file is absent or its
    ``tag`` does not match (a warning names the mismatch: the run's
    configuration or data changed, so resuming would be silently wrong).
    ``tag=None`` skips the guard.  ``path`` names the file the writers
    write (``.npz`` appended when missing), so an extension-less path finds
    its ``.npz``.
    """
    path = _npz_path(path)
    if not os.path.exists(path):
        return None
    f = np.load(path, allow_pickle=False)
    if tag is not None and str(f["tag"]) != tag:
        warnings.warn(
            "{} checkpoint at {} belongs to a different run "
            "(configuration/data changed); starting fresh".format(what, path)
        )
        return None
    return f


def remove_checkpoint(path):
    """Delete a finished run's checkpoint: the file ``atomic_savez`` wrote
    for ``path``."""
    path = _npz_path(path)
    if os.path.exists(path):
        os.remove(path)


def _leaves(tree):
    """Tensors / arrays of a NamedTuple tree, in field order."""
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _f64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(x, np.float64))


def config_tag(settings=(), arrays=(), pytrees=(), strings=()):
    """Checkpoint identity hash shared by the NUTS run tag
    (``models/inference.py``) and the SMC tag: run settings (repr'd
    tuple), arrays, the leaves of NamedTuple trees of tensors (``GPData``),
    each cast to float64, and identity strings
    (``mogp_tpu/utils/checkpoint.py:169-191``)."""
    h = hashlib.sha1()
    h.update(repr(tuple(settings)).encode())
    for arr in arrays:
        h.update(_f64(arr))
    for tree in pytrees:
        for leaf in _leaves(tree):
            h.update(_f64(leaf))
    for s in strings:
        h.update(str(s).encode())
    return h.hexdigest()


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
    # the models import this package (``utils.metrics``): import them at use
    from ..models.gp import GaussianProcess

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
    from ..models.mogp import MultiOutputGP

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


def save_mcmc(result, filename):
    """Checkpoint an ``MCMCResult``."""
    atomic_savez(
        filename,
        samples=result.samples,
        accept_prob=result.accept_prob,
        diverging=result.diverging,
        rhat=result.rhat,
        ess=result.ess,
    )


def load_mcmc(filename):
    """Load an ``MCMCResult`` written by :func:`save_mcmc`."""
    from ..models.inference import MCMCResult

    f = _load_npz(filename)
    return MCMCResult(
        samples=f["samples"],
        accept_prob=f["accept_prob"],
        diverging=f["diverging"],
        rhat=f["rhat"],
        ess=f["ess"],
    )


def _smc_tag(gp, obs_mean, obs_var, bounds, threshold, n_particles,
             n_stages, n_mcmc, discrepancy, include_nugget, quantile,
             rank, seed):
    """Checkpoint identity of an SMC anneal: its settings, the
    observations, the bounds and every emulator's data, so a changed
    posterior or configuration starts fresh."""
    ems = getattr(gp, "emulators", [gp])
    return config_tag(
        settings=(
            float(threshold), int(n_particles), int(n_stages), int(n_mcmc),
            float(discrepancy), bool(include_nugget), float(quantile),
            int(rank), int(seed),
        ),
        arrays=(obs_mean, obs_var, bounds),
        pytrees=[em._data for em in ems],
        strings=[
            "{}:{}:{}".format(type(em.kernel).__name__, em.nugget_type, em._standardize)
            for em in ems
        ],
    )


def save_smc(filename, state, tag=""):
    """Atomically persist an SMC anneal state.

    :param state: dict with ``particles``, ``scale``, ``key`` (the random
        stream's state: the seed and the next stage), ``stage``, ``taus``
        and ``accs`` (numpy arrays / ints).
    """
    atomic_savez(
        filename,
        tag=np.asarray(str(tag)),
        particles=np.asarray(state["particles"]),
        scale=np.asarray(state["scale"]),
        key=np.asarray(state["key"]),
        stage=np.asarray(int(state["stage"])),
        taus=np.asarray(state["taus"], dtype=np.float64),
        accs=np.asarray(state["accs"], dtype=np.float64),
    )


def load_smc(filename, tag=None):
    """Load an SMC anneal state, or ``None`` when absent or written by a
    different run (mismatched ``tag``)."""
    f = load_tagged(filename, tag, "SMC")
    if f is None:
        return None
    return {
        "particles": f["particles"],
        "scale": f["scale"],
        "key": f["key"],
        "stage": int(f["stage"]),
        "taus": f["taus"],
        "accs": f["accs"],
    }
