"""Nugget-aware Cholesky factorizations over a leading lanes axis.

Port of ``mogp_tpu/ops/cholesky.py`` (forward only):

* ``fixed_cholesky`` -- plain lower Cholesky.
* ``jit_cholesky``   -- adaptive jitter: an exact factorization, then a
  diagonal jitter of ``mean(diag(A)) * 1e-6 * 10**k``; the first candidate
  that factors wins, per lane.
* ``cholesky_factor`` -- dispatch on the nugget type.

``lax.linalg.cholesky`` fills a factor with NaN when the matrix is not
positive definite.  ``torch.linalg.cholesky_ex`` instead returns ``info``
and a partial factor, so :func:`_chol` turns ``info != 0`` into an all-NaN
factor for that lane alone, on the device and without a host sync.  A lane
whose every candidate fails gets an all-NaN factor and a NaN jitter, which
propagate to a NaN log posterior, as in the JAX package.

``"pivot"`` (pivoted Cholesky) and the factor-reusing ``_chol_of_sum``
gradient come with later PRs; ``ops/blocked.py`` is TPU tuning and is not
ported.
"""

from typing import NamedTuple

import torch

__all__ = ["ChoFactor", "fixed_cholesky", "jit_cholesky", "cholesky_factor"]

# Above this n, ``jit_cholesky`` factorizes the jitter candidates one after
# another and stops when every lane has one that factors, instead of
# factorizing all candidates in one batch: at large n each candidate costs
# real time and the first or second usually succeeds.
PROGRESSIVE_LADDER_MIN_N = 1024


def _chol(A):
    """Lower Cholesky of ``(..., n, n)``; lanes that are not positive
    definite come out all NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, torch.nan))


def _solve_lower(L, b):
    """Solve ``L x = b``; ``b`` is ``(..., n)`` or ``(..., n, k)``."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    x = torch.linalg.solve_triangular(L, b, upper=False)
    return x[..., 0] if vec else x


def _solve_lower_t(L, b):
    """Solve ``L^T x = b``."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), b, upper=True)
    return x[..., 0] if vec else x


class ChoFactor(NamedTuple):
    """Lower Cholesky factor ``(..., n, n)`` with the reference ``ChoInv``
    surface.  A zero-size factor (no mean parameters) solves to zeros and
    has log determinant zero."""

    L: torch.Tensor

    def solve(self, b):
        """Solve ``A x = b`` given ``A = L L^T``."""
        if self.L.shape[-1] == 0:
            return torch.zeros_like(b)
        return _solve_lower_t(self.L, _solve_lower(self.L, b))

    def solve_L(self, b):
        """Solve ``L x = b``."""
        if self.L.shape[-1] == 0:
            return torch.zeros_like(b)
        return _solve_lower(self.L, b)

    def solve_from_half(self, w):
        """Given ``w = solve_L(b)``, return ``solve(b)`` (one upper sweep)."""
        if self.L.shape[-1] == 0:
            return torch.zeros_like(w)
        return _solve_lower_t(self.L, w)

    def logdet(self):
        """``log det A = 2 sum log diag L``, shape ``(...)``."""
        diag = torch.diagonal(self.L, dim1=-2, dim2=-1)
        return 2.0 * torch.sum(torch.log(diag), dim=-1)


def fixed_cholesky(A):
    """Cholesky decomposition with a fixed noise level."""
    return _chol(A)


def _finite(L):
    return torch.isfinite(L).flatten(-2).all(dim=-1)


def jit_cholesky(A, maxtries=5, progressive_ok=True):
    """Jittered Cholesky of ``(..., n, n)``, per lane.

    Candidates are ``[0, d*1e-6, d*1e-5, ..., d*1e-6*10**(maxtries-1)]``
    with ``d = mean(diag(A))`` of the lane.  Below
    :data:`PROGRESSIVE_LADDER_MIN_N` (or with ``progressive_ok=False``) all
    candidates are factorized in one batched call and each lane takes its
    first finite factor.  Above it, candidates are factorized one rung at a
    time and the loop stops when every lane has a factor; that needs one
    host sync per rung.  Both forms select the same rung.

    :returns: ``(ChoFactor, jitter)``; ``jitter`` is ``(...)`` and NaN (with
        an all-NaN factor) where every candidate failed.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    mean_diag = torch.diagonal(A, dim1=-2, dim2=-1).mean(dim=-1)
    exponents = torch.pow(
        torch.tensor(10.0, dtype=A.dtype, device=A.device),
        torch.arange(maxtries, dtype=A.dtype, device=A.device),
    )
    scales = torch.cat([torch.zeros(1, dtype=A.dtype, device=A.device), 1e-6 * exponents])
    jitters = mean_diag[..., None] * scales  # (..., maxtries + 1)
    nan = torch.tensor(torch.nan, dtype=A.dtype, device=A.device)

    if progressive_ok and n >= PROGRESSIVE_LADDER_MIN_N:
        L = torch.full_like(A, torch.nan)
        jitter = torch.full_like(mean_diag, torch.nan)
        done = torch.zeros_like(mean_diag, dtype=torch.bool)
        for k in range(jitters.shape[-1]):
            Lk = _chol(A + jitters[..., k, None, None] * eye)
            take = _finite(Lk) & ~done
            L = torch.where(take[..., None, None], Lk, L)
            jitter = torch.where(take, jitters[..., k], jitter)
            done = done | take
            if bool(done.all()):
                break
        return ChoFactor(L), jitter

    batch = A[..., None, :, :] + jitters[..., :, None, None] * eye
    Ls = _chol(batch)  # (..., maxtries + 1, n, n)
    ok = _finite(Ls)
    idx = torch.argmax(ok.to(torch.int8), dim=-1)  # first finite candidate
    any_ok = ok.any(dim=-1)
    jitter = torch.where(any_ok, torch.gather(jitters, -1, idx[..., None])[..., 0], nan)
    gather_idx = idx[..., None, None, None].expand(*idx.shape, 1, n, n)
    L = torch.gather(Ls, -3, gather_idx)[..., 0, :, :]
    L = torch.where(any_ok[..., None, None], L, nan)
    return ChoFactor(L), jitter


def cholesky_factor(K, nugget, nugget_type, progressive_ok=True):
    """Factorize ``K`` by nugget type.

    :param K: ``(..., n, n)`` covariance without nugget.
    :param nugget: ``(...)`` nugget (ignored for ``"adaptive"``).
    :param nugget_type: ``"adaptive"``, ``"fit"`` or ``"fixed"``;
        ``"pivot"`` raises ``NotImplementedError``.
    :returns: ``(ChoFactor, nugget)`` with the realized nugget.
    """
    if nugget_type == "adaptive":
        return jit_cholesky(K, progressive_ok=progressive_ok)
    if nugget_type == "pivot":
        raise NotImplementedError(
            "pivoted Cholesky (nugget='pivot') is not ported to mogp_tpu_torch yet"
        )
    if nugget_type in ("fit", "fixed"):
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        nugget = torch.as_tensor(nugget, dtype=K.dtype, device=K.device)
        return ChoFactor(fixed_cholesky(K + nugget[..., None, None] * eye)), nugget
    raise ValueError("Bad value for nugget_type in cholesky_factor")
