"""Nugget-aware Cholesky factorizations over a leading lanes axis.

Port of ``mogp_tpu/ops/cholesky.py``:

* ``fixed_cholesky`` -- plain lower Cholesky.
* ``jit_cholesky``   -- adaptive jitter: an exact factorization, then a
  diagonal jitter of ``mean(diag(A)) * 1e-6 * 10**k``; the first candidate
  that factors wins, per lane.  The optimizer's trajectory may use the
  sparse (3-rung) or single (1-rung) ladder instead.
* ``cholesky_factor`` -- dispatch on the nugget type.

Every factorization goes through K2, ``ops/cholesky_batched.py`` (the CUDA
kernel on the card, its plain version on the CPU): a lane that is not
positive definite gets an all-NaN factor, on the device and without a
host sync.  A lane whose every candidate fails gets an all-NaN factor and
a NaN jitter, which propagate to a NaN log posterior, as in the JAX
package.

Gradients: :func:`fixed_cholesky` is a ``torch.autograd.Function`` whose
forward is K2 and whose backward is the Cholesky reverse rule in plain,
differentiable torch (so it differentiates twice, for Hessians).
``jit_cholesky`` picks its jitter on a detached copy, and with
``reuse_factor`` returns the selected candidate through
:func:`_chol_of_sum`, which has the same backward and costs no second
factorization.

``"pivot"`` (pivoted Cholesky) is not ported yet; ``ops/blocked.py`` is TPU
tuning and is not ported.
"""

from typing import NamedTuple

import torch

from .cholesky_batched import cholesky_batched

__all__ = ["ChoFactor", "fixed_cholesky", "jit_cholesky", "cholesky_factor"]

# Above this n, ``jit_cholesky`` factorizes the jitter candidates one after
# another and stops when every lane has one that factors, instead of
# factorizing all candidates in one batch: at large n each candidate costs
# real time and the first or second usually succeeds.
PROGRESSIVE_LADDER_MIN_N = 1024


def _factor(A):
    """K2 over any leading shape ``(..., n, n)``, outside autograd."""
    n = A.shape[-1]
    return cholesky_batched(A.reshape(A.shape[:-2].numel(), n, n).contiguous()).reshape(A.shape)


def _chol_bwd(L, L_bar):
    """Cholesky reverse rule (``mogp_tpu/ops/cholesky.py:376-385``): with
    ``S = Phi(L^T L_bar)`` (lower triangle, halved diagonal),
    ``M_bar = 0.5 * sym(L^-T S L^-1)``.  Plain differentiable torch."""
    if L.shape[-1] == 0:
        return torch.zeros_like(L_bar)
    Lt = L.transpose(-1, -2)
    S = torch.tril(Lt @ L_bar)
    S = S - 0.5 * torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
    W = torch.linalg.solve_triangular(Lt, S, upper=True)
    W = torch.linalg.solve_triangular(Lt, W.transpose(-1, -2), upper=True).transpose(-1, -2)
    return 0.5 * (W + W.transpose(-1, -2))


class _Cholesky(torch.autograd.Function):
    """Lower Cholesky factor of ``A``: K2 forward, reverse rule backward."""

    @staticmethod
    def forward(ctx, A):
        L = _factor(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        return _chol_bwd(L, L_bar)


class _CholOfSum(torch.autograd.Function):
    """A precomputed factor of ``M``, differentiable in ``M`` as if it were
    the Cholesky of ``M``: the forward reuses a factor computed on a
    detached copy."""

    @staticmethod
    def forward(ctx, M, L_precomputed):
        L = L_precomputed.clone()
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        return _chol_bwd(L, L_bar), None


def _chol(A):
    """Lower Cholesky of ``(..., n, n)``; lanes that are not positive
    definite come out all NaN."""
    return _Cholesky.apply(A)


def _chol_of_sum(M, L_precomputed):
    """Return (a copy of) ``L_precomputed``, differentiable in ``M`` with
    the Cholesky reverse rule."""
    return _CholOfSum.apply(M, L_precomputed)


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


def jit_cholesky(A, maxtries=5, reuse_factor=True, sparse_ladder=False,
                 progressive_ok=True):
    """Jittered Cholesky of ``(..., n, n)``, per lane.

    The jitter candidates are computed on ``A.detach()``: the selected
    jitter is a constant for autograd, as ``lax.stop_gradient`` makes it
    in the JAX package.  With ``d = mean(diag(A))`` of the lane they are

    * ``sparse_ladder=False``: ``[0, d*1e-6, d*1e-5, ..., d*1e-6*10**(maxtries-1)]``;
    * ``sparse_ladder=True``: ``[0, d*1e-6, d*1e-2]``;
    * ``sparse_ladder="single"``: ``[d*1e-6]`` alone.  Points where it
      fails evaluate to NaN; only the optimizer's trajectory uses it.

    All candidates are factorized in one batched call and each lane takes
    its first finite factor.  With the full ladder, at n >=
    :data:`PROGRESSIVE_LADDER_MIN_N` and ``progressive_ok``, candidates are
    factorized one rung at a time instead, until every lane has a factor
    (one host sync per rung); both forms select the same rung.

    ``reuse_factor`` returns the selected candidate through
    :func:`_chol_of_sum` (no second factorization); otherwise ``A +
    jitter I`` is factorized again through :func:`_chol`.

    :returns: ``(ChoFactor, jitter)``; ``jitter`` is ``(...)`` and NaN (with
        an all-NaN factor) where every candidate failed.
    """
    A_sg = A.detach()
    n = A.shape[-1]
    dtype, device = A.dtype, A.device
    eye = torch.eye(n, dtype=dtype, device=device)
    mean_diag = torch.diagonal(A_sg, dim1=-2, dim2=-1).mean(dim=-1)[..., None]
    if sparse_ladder == "single":
        jitters = mean_diag * torch.tensor([1e-6], dtype=dtype, device=device)
    elif sparse_ladder:
        jitters = mean_diag * torch.tensor([0.0, 1e-6, 1e-2], dtype=dtype, device=device)
    else:
        exponents = torch.pow(
            torch.tensor(10.0, dtype=dtype, device=device),
            torch.arange(maxtries, dtype=dtype, device=device),
        )
        jitters = torch.cat([torch.zeros_like(mean_diag), mean_diag * 1e-6 * exponents], dim=-1)
    nan = torch.tensor(torch.nan, dtype=dtype, device=device)

    if progressive_ok and sparse_ladder is False and n >= PROGRESSIVE_LADDER_MIN_N:
        L_sel = torch.full_like(A_sg, torch.nan)
        jitter = torch.full_like(mean_diag[..., 0], torch.nan)
        done = torch.zeros_like(jitter, dtype=torch.bool)
        for k in range(jitters.shape[-1]):
            Lk = _factor(A_sg + jitters[..., k, None, None] * eye)
            take = _finite(Lk) & ~done
            L_sel = torch.where(take[..., None, None], Lk, L_sel)
            jitter = torch.where(take, jitters[..., k], jitter)
            done = done | take
            if bool(done.all()):
                break
    else:
        Ls = _factor(A_sg[..., None, :, :] + jitters[..., :, None, None] * eye)
        ok = _finite(Ls)
        idx = torch.argmax(ok.to(torch.int8), dim=-1)  # first finite candidate
        any_ok = ok.any(dim=-1)
        jitter = torch.where(any_ok, torch.gather(jitters, -1, idx[..., None])[..., 0], nan)
        gather_idx = idx[..., None, None, None].expand(*idx.shape, 1, n, n)
        L_sel = torch.gather(Ls, -3, gather_idx)[..., 0, :, :]
        L_sel = torch.where(any_ok[..., None, None], L_sel, nan)

    A_jit = A + jitter[..., None, None] * eye
    L = _chol_of_sum(A_jit, L_sel) if reuse_factor else _chol(A_jit)
    return ChoFactor(L), jitter


def cholesky_factor(K, nugget, nugget_type, reuse_factor=True, sparse_ladder=False,
                    progressive_ok=True):
    """Factorize ``K`` by nugget type.

    :param K: ``(..., n, n)`` covariance without nugget.
    :param nugget: ``(...)`` nugget (ignored for ``"adaptive"``).
    :param nugget_type: ``"adaptive"``, ``"fit"`` or ``"fixed"``;
        ``"pivot"`` raises ``NotImplementedError``.
    :param reuse_factor, sparse_ladder, progressive_ok: passed to
        :func:`jit_cholesky` for ``"adaptive"``.
    :returns: ``(ChoFactor, nugget)`` with the realized nugget.
    """
    if nugget_type == "adaptive":
        return jit_cholesky(K, reuse_factor=reuse_factor, sparse_ladder=sparse_ladder,
                            progressive_ok=progressive_ok)
    if nugget_type == "pivot":
        raise NotImplementedError(
            "pivoted Cholesky (nugget='pivot') is not ported to mogp_tpu_torch yet"
        )
    if nugget_type in ("fit", "fixed"):
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        nugget = torch.as_tensor(nugget, dtype=K.dtype, device=K.device)
        return ChoFactor(fixed_cholesky(K + nugget[..., None, None] * eye)), nugget
    raise ValueError("Bad value for nugget_type in cholesky_factor")
