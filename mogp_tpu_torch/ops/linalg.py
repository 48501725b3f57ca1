"""Marginalized-mean GP linear algebra over a leading lanes axis.

Port of ``mogp_tpu/ops/linalg.py``: everything the marginalized-mean math
needs comes from ONE stacked lower-triangular half-solve

    W = L^-1 [H | (y - m)].
"""

import contextlib
import math
from typing import NamedTuple

import torch

from ..utils import metrics
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
    ``H_Kinv_t = H^T K^-1 (y-m)``; ``quad`` (...) the quadratic form of
    the marginal likelihood, ``(y-m)^T (K + H B H^T)^-1 (y-m)``.
    """

    W: torch.Tensor
    Wh: torch.Tensor
    alpha: torch.Tensor
    Ainv: ChoFactor
    H_Kinv_t: torch.Tensor
    quad: torch.Tensor


def marginal_core(Kinv, dm, resid, mean_inv_cov):
    """One stacked half-solve giving the marginalized-mean artifacts.

    :param Kinv: covariance factor, ``(..., n, n)``: a ``ChoFactor``, or a
        ``PivotedChoFactor`` whose permuted, rank-masked half-solve gives
        ``W`` (``nugget="pivot"``).
    :param dm: design matrix ``H`` ``(..., n, M)``.
    :param resid: ``y - H b`` ``(..., n)``.
    :param mean_inv_cov: ``B^-1`` ``(..., M, M)``, zeros for weak priors.

    The quadratic form is ``|alpha|^2 - H_Kinv_t^T A^-1 H_Kinv_t``.  With a
    mean it is taken as ``|alpha - Wh d|^2 + d^T B^-1 d``, ``d = A^-1
    H_Kinv_t`` (the coefficients' shift from their prior mean), the same
    number with no difference of two large ones: where the mean explains
    nearly all of ``y - m``, the first form cancels every digit of float32
    and can come out negative, a spurious minimum of the objective that the
    optimizer walks into.

    Where ``M > 0`` the work that exists only with a mean, ``A``, its
    factor, ``H^T K^-1 (y - m)`` and ``d``, is the span ``gp.mean`` of the
    recorder (``utils/metrics.py``): its enqueue, seen in eager calls and in
    a CUDA graph's warm-ups, not in its replays.
    """
    rhs = torch.cat([dm, resid[..., None]], dim=-1)
    W = Kinv.solve_L(rhs)
    Wh, alpha = W[..., :-1], W[..., -1]
    WhT = Wh.transpose(-1, -2)
    with metrics.span("gp.mean") if dm.shape[-1] else contextlib.nullcontext():
        A = dot_hp(WhT, Wh) + mean_inv_cov
        Ainv = ChoFactor(fixed_cholesky(A))
        H_Kinv_t = dot_hp(WhT, alpha[..., None])[..., 0]
        if dm.shape[-1]:
            d = Ainv.solve(H_Kinv_t)
            e = alpha - dot_hp(Wh, d[..., None])[..., 0]
            quad = _vdot(e, e) + _vdot(d, dot_hp(mean_inv_cov, d[..., None])[..., 0])
        else:
            quad = _vdot(alpha, alpha)
    return MarginalCore(W=W, Wh=Wh, alpha=alpha, Ainv=Ainv, H_Kinv_t=H_Kinv_t, quad=quad)


def marginal_nlp(core: MarginalCore, Kinv, mean_logdet_cov, n_coeff):
    """Negative log marginal posterior data terms: quadratic form, the
    mean-marginalization correction and all log-determinant terms."""
    return 0.5 * (
        core.quad
        + Kinv.logdet()
        + core.Ainv.logdet()
        + mean_logdet_cov
        + n_coeff * math.log(2.0 * math.pi)
    )
