"""Marginalized-mean GP linear algebra over a leading lanes axis.

Port of ``mogp_tpu/ops/linalg.py``: everything the marginalized-mean math
needs comes from ONE stacked lower-triangular half-solve

    W = L^-1 [H | (y - m)].
"""

from typing import NamedTuple

import math

import torch

from .cholesky import ChoFactor, fixed_cholesky

__all__ = ["MarginalCore", "marginal_core", "marginal_nlp", "dot_hp"]


def dot_hp(a, b):
    """Matrix product for the mean-marginalization algebra.

    A plain ``@``: full float32 or float64 because ``mogp_tpu_torch.config``
    switches TF32 off when the package is imported.  That matters here.
    ``Wh = L^-1 H`` carries entries amplified by ``K^-1``, and on the TPU an
    8-bit-mantissa pass turned the mean coefficients into garbage
    (``mogp_tpu/ops/linalg.py:30-39``); TF32's 10-bit mantissa is the same
    hazard on this card.  The products are tiny (n x M with M small) next
    to the factorization.
    """
    return a @ b


def _vdot(a, b):
    """Batched inner product over the last axis."""
    return torch.sum(a * b, dim=-1)


class MarginalCore(NamedTuple):
    """Artifacts of the stacked half-solve shared by fit and objective.

    ``W = L^-1 [H | (y-m)]`` split into ``Wh`` (..., n, M) and ``alpha``
    (..., n); ``Ainv`` factors ``A = H^T K^-1 H + B^-1``;
    ``H_Kinv_t = H^T K^-1 (y-m)``.
    """

    W: torch.Tensor
    Wh: torch.Tensor
    alpha: torch.Tensor
    Ainv: ChoFactor
    H_Kinv_t: torch.Tensor


def marginal_core(Kinv, dm, resid, mean_inv_cov):
    """One stacked half-solve giving the marginalized-mean artifacts.

    :param Kinv: covariance factor, ``(..., n, n)``: a ``ChoFactor``, or a
        ``PivotedChoFactor`` whose permuted, rank-masked half-solve gives
        ``W`` (``nugget="pivot"``).
    :param dm: design matrix ``H`` ``(..., n, M)``.
    :param resid: ``y - H b`` ``(..., n)``.
    :param mean_inv_cov: ``B^-1`` ``(..., M, M)``, zeros for weak priors.
    """
    rhs = torch.cat([dm, resid[..., None]], dim=-1)
    W = Kinv.solve_L(rhs)
    Wh, alpha = W[..., :-1], W[..., -1]
    WhT = Wh.transpose(-1, -2)
    A = dot_hp(WhT, Wh) + mean_inv_cov
    Ainv = ChoFactor(fixed_cholesky(A))
    H_Kinv_t = dot_hp(WhT, alpha[..., None])[..., 0]
    return MarginalCore(W=W, Wh=Wh, alpha=alpha, Ainv=Ainv, H_Kinv_t=H_Kinv_t)


def marginal_nlp(core: MarginalCore, Kinv, mean_logdet_cov, n_coeff):
    """Negative log marginal posterior data terms: quadratic form, the
    mean-marginalization correction and all log-determinant terms."""
    return 0.5 * (
        _vdot(core.alpha, core.alpha)
        - _vdot(core.H_Kinv_t, core.Ainv.solve(core.H_Kinv_t))
        + Kinv.logdet()
        + core.Ainv.logdet()
        + mean_logdet_cov
        + n_coeff * math.log(2.0 * math.pi)
    )
