"""Post-fit validation diagnostics: standard/pivoted errors, Mahalanobis.

Port of ``mogp_tpu/uq/validation.py`` (``mogp_emulator/validation.py``),
with its strategy classes (``Errors`` / ``StandardErrors`` /
``PivotErrors``).  The pivoted errors factor the predictive covariances on
the emulator's device with ``ops/cholesky.py``'s ``pivoted_cholesky``:
for a ``MultiOutputGP``, all outputs' covariances in one batched call
(the JAX package loops over outputs; the results are the same).  The
scaled-F distribution of the Mahalanobis distance is scipy's, on the host.
"""

import numpy as np
import torch
from scipy.stats import f

from ..config import default_dtype, resolve_device
from ..models.gp import GaussianProcessBase
from ..models.mogp import MultiOutputGPBase
from ..ops.cholesky import pivoted_cholesky

__all__ = [
    "mahalanobis",
    "generate_mahal_dist",
    "compute_errors",
    "standard_errors",
    "pivoted_errors",
    "Errors",
    "StandardErrors",
    "PivotErrors",
]


def _check_valid_data(gp, valid_inputs, valid_targets):
    """Validation-data checks (``validation.py:443-482``)."""
    assert isinstance(gp, (GaussianProcessBase, MultiOutputGPBase)), (
        "Must provide a GP to validate"
    )
    valid_inputs = gp._process_inputs(valid_inputs)
    valid_targets = np.asarray(valid_targets)
    if isinstance(gp, GaussianProcessBase):
        assert valid_targets.ndim == 1, "Targets for a GP must be a 1D array"
        assert valid_targets.shape[0] == valid_inputs.shape[0], (
            "Bad length for validation targets"
        )
    else:
        assert valid_targets.ndim == 2, (
            "Targets for a MultiOutputGP must be a 2D array"
        )
        assert valid_targets.shape[1] == valid_inputs.shape[0], (
            "Bad shape for validation targets"
        )


class Errors:
    """Error-computation strategy base (``validation.py:352-361``)."""

    full_cov = False

    def __call__(self, target, mean, cov):
        raise NotImplementedError


class StandardErrors(Errors):
    """Z-scores ordered by decreasing predictive variance
    (``validation.py:363-400``)."""

    full_cov = False

    def __call__(self, target, mean, cov):
        P = np.argsort(cov)[::-1]
        error = ((mean - target) / np.sqrt(cov))[P]
        return error, P


class PivotErrors(Errors):
    """Correlated errors via pivoted-Cholesky whitening
    (``validation.py:403-441``).

    ``target`` and ``mean`` are ``(n,)`` and ``cov`` ``(n, n)``, or all
    carry a leading outputs axis, which is factored in one batched call.
    They are factored on ``device`` in ``dtype``: as for every entry point,
    the card unless ``device="cpu"``, in float32 there and float64 on the
    CPU by default.  :func:`pivoted_errors` and :func:`mahalanobis` give it
    the emulator's."""

    full_cov = True

    def __init__(self, device=None, dtype=None):
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype

    def __call__(self, target, mean, cov):
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

        cov_inv = pivoted_cholesky(t(cov))
        error = cov_inv.solve_L(t(np.asarray(mean) - np.asarray(target)))
        return (error.to("cpu", torch.float64).numpy(),
                cov_inv.P.cpu().numpy())


def compute_errors(gp, valid_inputs, valid_targets, method):
    """Generic error computation (``validation.py:138-238``).  A
    ``PivotErrors`` method takes all outputs of a ``MultiOutputGP`` in one
    batch, on its own device."""
    _check_valid_data(gp, valid_inputs, valid_targets)
    mean, cov, _ = gp.predict(valid_inputs, full_cov=method.full_cov)
    valid_targets = np.asarray(valid_targets)
    single = isinstance(gp, GaussianProcessBase)

    if isinstance(method, PivotErrors):
        errors, perms = method(valid_targets, mean, cov)
        return (errors, perms) if single else list(zip(errors, perms))

    if single:
        return method(valid_targets, mean, cov)
    return [method(target, m, c) for (target, m, c) in zip(valid_targets, mean, cov)]


def standard_errors(gp, valid_inputs, valid_targets):
    """Standard errors on a validation set (``validation.py:240-295``)."""
    return compute_errors(gp, valid_inputs, valid_targets, method=StandardErrors())


def pivoted_errors(gp, valid_inputs, valid_targets):
    """Correlated (pivoted) errors on a validation set
    (``validation.py:296-350``), factored on the emulator's device in its
    type."""
    _check_valid_data(gp, valid_inputs, valid_targets)
    em = gp if isinstance(gp, GaussianProcessBase) else gp.emulators[0]
    return compute_errors(gp, valid_inputs, valid_targets,
                          method=PivotErrors(em._device, em._dtype))


def generate_mahal_dist(gp, valid_inputs):
    """Expected scaled-F distribution of the Mahalanobis distance
    (``validation.py:98-137``)."""
    if isinstance(gp, GaussianProcessBase):
        emulators = [gp]
    elif isinstance(gp, MultiOutputGPBase):
        emulators = gp.emulators
    else:
        raise TypeError("Provided GP is not a GaussianProcess or MultiOutputGP")

    n_valid = len(gp._process_inputs(valid_inputs))
    outdists = [
        f(dfn=n_valid, dfd=em.n - em.n_mean - 2, scale=n_valid)
        for em in emulators
    ]
    if len(outdists) == 1:
        return outdists[0]
    return outdists


def mahalanobis(gp, valid_inputs, valid_targets, scaled=False):
    """Mahalanobis distance on a validation set (``validation.py:8-97``)."""
    pivot_errors_out = pivoted_errors(gp, valid_inputs, valid_targets)

    if isinstance(gp, GaussianProcessBase):
        errors = pivot_errors_out[0]
    else:
        errors = np.array([err[0] for err in pivot_errors_out])

    M = np.sum(errors**2, axis=-1)

    if scaled:
        expected_dists = generate_mahal_dist(gp, valid_inputs)
        if isinstance(gp, GaussianProcessBase):
            M_iter = [M]
            dists_iter = [expected_dists]
        else:
            M_iter = M
            dists_iter = expected_dists
        M_out = []
        for M_val, dist in zip(M_iter, dists_iter):
            mean, var = dist.stats()
            M_out.append((M_val - mean) / np.sqrt(var))
        M = np.array(M_out)
        if isinstance(gp, GaussianProcessBase):
            M = M.squeeze(axis=0)
    return M
