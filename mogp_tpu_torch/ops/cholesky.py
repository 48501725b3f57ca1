"""Nugget-aware Cholesky factorizations over a leading lanes axis.

Port of ``mogp_tpu/ops/cholesky.py``:

* ``fixed_cholesky`` -- plain lower Cholesky.
* ``jit_cholesky``   -- adaptive jitter: an exact factorization, then a
  diagonal jitter of ``mean(diag(A)) * 1e-6 * 10**k``; the first candidate
  that factors wins, per lane.  The optimizer's trajectory may use the
  sparse (3-rung) or single (1-rung) ladder instead.
* ``pivoted_cholesky`` -- greedy diagonal pivoting with rank detection
  (``nugget="pivot"``), returning a :class:`PivotedChoFactor`.
* ``cholesky_factor`` -- dispatch on the nugget type.

Every factorization goes through ``ops/cholesky_batched.py``'s
``cholesky_batched``, which routes by size (``route``): K2 up to n = 340
in float32 / 240 in float64, the blocked K3-K5 (``ops/cholesky_blocked.py``)
above, such as the large-n GP's progressive ladder.  On the card those are
CUDA kernels, on the CPU their plain version.  A lane that is not
positive definite gets an all-NaN factor, on the device and without a
host sync.  A lane whose every candidate fails gets an all-NaN factor and
a NaN jitter, which propagate to a NaN log posterior, as in the JAX
package.

Gradients: :func:`fixed_cholesky` is a ``torch.autograd.Function`` whose
forward is the routed kernel and whose backward is the Cholesky reverse
rule in plain, differentiable torch (so it differentiates twice, for
Hessians).
``jit_cholesky`` picks its jitter on a detached copy, and with
``reuse_factor`` returns the selected candidate through
:func:`_chol_of_sum`, which has the same backward and costs no second
factorization.

:func:`pivoted_cholesky` finds each lane's permutation and rank without
autograd, then builds the factor differentiably from the permuted matrix:
the routed Cholesky of the rank-``r`` leading block, the rows below it by
one triangular solve, and the reference's synthetic tail diagonal.  No
step of the search is kept for the backward pass.

``ops/blocked.py`` is TPU tuning and is not ported.
"""

from typing import NamedTuple

import torch

from ..utils import metrics
from .cholesky_batched import cholesky_batched

__all__ = [
    "ChoFactor",
    "PivotedChoFactor",
    "fixed_cholesky",
    "jit_cholesky",
    "jitter_ladder",
    "pivoted_cholesky",
    "cholesky_factor",
]

# Above this n, ``jit_cholesky`` factorizes the jitter candidates one after
# another and stops when every lane has one that factors, instead of
# factorizing all candidates in one batch: at large n each candidate costs
# real time and the first or second usually succeeds.
PROGRESSIVE_LADDER_MIN_N = 1024


def _factor(A):
    """The routed Cholesky (K2 or blocked) over any leading shape ``(..., n,
    n)``, outside autograd.  Counts (``utils/metrics.py``) the matrices it
    factors, ``chol.matrices`` (none of 0 x 0, such as a zero mean's),
    whichever kernel the route takes."""
    n = A.shape[-1]
    batch = A.shape[:-2].numel()
    if n:
        metrics.count("chol.matrices", batch)
    return cholesky_batched(A.reshape(batch, n, n).contiguous()).reshape(A.shape)


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
    """Lower Cholesky factor of ``A``: the routed kernel forward, reverse
    rule backward."""

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


def _permute_rows(b, P):
    """``b[..., P]`` for vectors ``(..., n)``, ``b[..., P, :]`` for
    ``(..., n, k)``, per lane (``P`` is ``(..., n)``)."""
    if b.ndim == P.ndim:
        return torch.gather(b, -1, P)
    return torch.gather(b, -2, P[..., None].expand(*P.shape, b.shape[-1]))


class PivotedChoFactor(NamedTuple):
    """Pivoted Cholesky factor with per-lane permutation and rank: ``L``
    ``(..., n, n)``, ``P`` ``(..., n)`` int64 with ``A[P][:, P] ~= L L^T``,
    ``rank`` ``(...)`` int64.  Solves drop the components in the
    rank-deficient tail (the reference's "skip collinear rows")."""

    L: torch.Tensor
    P: torch.Tensor
    rank: torch.Tensor

    def _mask(self, x):
        keep = torch.arange(self.L.shape[-1], device=x.device) < self.rank[..., None]
        if x.ndim > self.P.ndim:
            keep = keep[..., None]
        return torch.where(keep, x, 0.0)

    def _unpermute(self, x):
        return _permute_rows(x, torch.argsort(self.P, dim=-1))

    def solve(self, b):
        """Permuted solve with rank masking."""
        return self.solve_from_half(self.solve_L(b))

    def solve_L(self, b):
        """Permuted lower solve with rank masking."""
        return self._mask(_solve_lower(self.L, _permute_rows(b, self.P)))

    def solve_from_half(self, w):
        """Complete a full solve from ``w = solve_L(b)``: the upper sweep
        and the inverse permutation (the rank mask is already in ``w``)."""
        return self._unpermute(_solve_lower_t(self.L, w))

    def logdet(self):
        diag = torch.diagonal(self.L, dim1=-2, dim2=-1)
        return 2.0 * torch.sum(torch.log(diag), dim=-1)


def fixed_cholesky(A):
    """Cholesky decomposition with a fixed noise level."""
    return _chol(A)


def _finite(L):
    return torch.isfinite(L).flatten(-2).all(dim=-1)


def jitter_ladder(A, maxtries=5, sparse_ladder=False, jitter_mask=None):
    """The jitter candidates ``(..., k)`` of :func:`jit_cholesky` for
    ``A`` ``(..., n, n)`` (detached), in the order it tries them.  With a
    ``jitter_mask`` ``(..., n)``, ``mean(diag)`` is taken over the marked
    rows only, divided by ``max(sum(mask), 1)``."""
    dtype, device = A.dtype, A.device
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    if jitter_mask is None:
        mean_diag = diag.mean(dim=-1)[..., None]
    else:
        mask = jitter_mask.to(dtype)
        mean_diag = (torch.sum(mask * diag, dim=-1)
                     / torch.clamp_min(torch.sum(mask, dim=-1), 1.0))[..., None]
    if sparse_ladder == "single":
        # a Python scalar: no host-to-device copy, so the potential that
        # NUTS and VI evaluate, and the MAP fit's objective, can be
        # captured in CUDA graphs
        return mean_diag * 1e-6
    if sparse_ladder:
        return mean_diag * torch.tensor([0.0, 1e-6, 1e-2], dtype=dtype, device=device)
    exponents = torch.pow(
        torch.tensor(10.0, dtype=dtype, device=device),
        torch.arange(maxtries, dtype=dtype, device=device),
    )
    return torch.cat([torch.zeros_like(mean_diag), mean_diag * 1e-6 * exponents], dim=-1)


def _jitter_eye(n, jitter_mask, dtype, device):
    """The matrix the jitter (or nugget) multiplies: the identity, or
    ``diag(jitter_mask)`` ``(..., n, n)``."""
    if jitter_mask is None:
        return torch.eye(n, dtype=dtype, device=device)
    return torch.diag_embed(jitter_mask.to(dtype))


def jit_cholesky(A, maxtries=5, reuse_factor=True, sparse_ladder=False,
                 progressive_ok=True, jitter_mask=None):
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

    ``jitter_mask`` ``(..., n)``, 0/1 (the fixed-shape MICE design,
    ``uq/mice_device.py``): ``d`` is the mean of the marked rows' diagonal
    and the jitter is added on ``diag(mask)`` only, so a masked row of
    ``m m^T * K + diag(1 - m)`` factors as an exact unit pivot, adding
    nothing to the log determinant and nothing to the marked rows.

    :returns: ``(ChoFactor, jitter)``; ``jitter`` is ``(...)`` and NaN (with
        an all-NaN factor) where every candidate failed.
    """
    A_sg = A.detach()
    n = A.shape[-1]
    dtype, device = A.dtype, A.device
    eye = _jitter_eye(n, jitter_mask, dtype, device)
    jitters = jitter_ladder(A_sg, maxtries, sparse_ladder, jitter_mask)

    if progressive_ok and sparse_ladder is False and n >= PROGRESSIVE_LADDER_MIN_N:
        L_sel = torch.full_like(A_sg, torch.nan)
        jitter = torch.full_like(jitters[..., 0], torch.nan)
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
        Ls = _factor(A_sg[..., None, :, :] + jitters[..., :, None, None] * eye.unsqueeze(-3))
        ok = _finite(Ls)
        idx = torch.argmax(ok.to(torch.int8), dim=-1)  # first finite candidate
        any_ok = ok.any(dim=-1)
        jitter = torch.where(any_ok, torch.gather(jitters, -1, idx[..., None])[..., 0], torch.nan)
        gather_idx = idx[..., None, None, None].expand(*idx.shape, 1, n, n)
        L_sel = torch.gather(Ls, -3, gather_idx)[..., 0, :, :]
        L_sel = torch.where(any_ok[..., None, None], L_sel, torch.nan)

    A_jit = A + jitter[..., None, None] * eye
    L = _chol_of_sum(A_jit, L_sel) if reuse_factor else _chol(A_jit)
    return ChoFactor(L), jitter


@torch.no_grad()
def _pivot_search(A):
    """Permutation ``(B, n)`` and rank ``(B,)`` of ``mogp_tpu``'s pivoted
    Cholesky of ``A`` ``(B, n, n)``.

    The same steps as ``mogp_tpu/ops/cholesky.py::pivoted_cholesky``: at
    step ``k`` the position of the largest remaining Schur-complement
    diagonal (the first one on ties, in the current order) is swapped
    into ``k``; a lane stays active while its pivots exceed ``n * eps *
    max(diag A)``, and its later steps only swap by the frozen diagonal.
    The factor's columns are kept in the original row order (``G``), so
    that no matrix is swapped, only the diagonal ``d`` and ``perm``."""
    B, n, _ = A.shape
    dtype, device = A.dtype, A.device
    eps = torch.finfo(dtype).eps
    lanes = torch.arange(B, device=device)
    idx = torch.arange(n, device=device)
    d = torch.diagonal(A, dim1=-2, dim2=-1).clone()
    tol = n * eps * d.max(dim=-1).values
    perm = idx.expand(B, n).clone()
    G = torch.zeros_like(A)
    chosen = torch.zeros(B, n, dtype=torch.bool, device=device)
    rank = torch.zeros(B, dtype=torch.int64, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    for k in range(n):
        j = k + torch.argmax(d[:, k:], dim=-1)
        dk, pk = d[:, k].clone(), perm[:, k].clone()
        d[:, k], perm[:, k] = d[lanes, j], perm[lanes, j]
        d[lanes, j], perm[lanes, j] = dk, pk
        pivot, p = d[:, k], perm[:, k]
        active &= pivot > tol
        lkk = torch.sqrt(torch.clamp_min(pivot, eps))
        # column k of L, rows in the original order: (A[:, p] - L[:, :k] L[p, :k]) / lkk
        col = (A[lanes, :, p] - (G[:, :, :k] @ G[lanes, p, :k, None])[..., 0]) / lkk[:, None]
        chosen[lanes, p] = True
        col = torch.where(chosen, 0.0, col)
        col[lanes, p] = lkk
        G[:, :, k] = torch.where(active[:, None], col, 0.0)
        later = active[:, None] & (idx > k)
        d = torch.where(later, d - torch.gather(col, 1, perm) ** 2, d)
        rank += active.to(torch.int64)
    return perm, rank


def pivoted_cholesky(A):
    """Pivoted Cholesky of ``(..., n, n)``: ``PivotedChoFactor(L, P, rank)``.

    Port of ``mogp_tpu/ops/cholesky.py:391-464``: greedy diagonal pivoting,
    the rank at the LAPACK ``dpstrf`` tolerance ``n * eps * max(diag)``, the
    deficient columns zeroed and their diagonal replaced by the reference's
    decreasing sequence ``L[r-1, r-1] * r! / (i+1)!`` (through ``lgamma``),
    so log-determinants agree.

    The permutation and rank come from :func:`_pivot_search` outside
    autograd.  The factor is then built, differentiably in ``A``, from the
    permuted matrix: the routed Cholesky (K2 on the card at the emulators'
    sizes) of the rank-``r`` leading block, masked to the identity past
    ``r``; the rows below it as ``A21 L11^-T``; the tail diagonal.  It is
    the factor of the search, and autograd keeps one ``(n, n)`` matrix per
    step of this build, not one per pivot.
    """
    shape, n = A.shape, A.shape[-1]
    A = A.reshape(-1, n, n)
    perm, rank = _pivot_search(A.detach())
    L = _pivoted_factor(A, perm, rank)
    return PivotedChoFactor(L.reshape(shape), perm.reshape(shape[:-1]), rank.reshape(shape[:-2]))


def _pivoted_factor(A, perm, rank):
    """The factor ``L`` ``(B, n, n)`` of :func:`pivoted_cholesky` for the
    permutation and rank of :func:`_pivot_search`, differentiable in ``A``."""
    B, n, _ = A.shape
    dtype, device = A.dtype, A.device
    idx = torch.arange(n, device=device)
    lanes = torch.arange(B, device=device)

    Ap = torch.gather(A, -2, perm[:, :, None].expand(B, n, n))
    Ap = torch.gather(Ap, -1, perm[:, None, :].expand(B, n, n))
    lead = idx < rank[:, None]
    block = lead[:, :, None] & lead[:, None, :]
    eye = torch.eye(n, dtype=dtype, device=device)
    Lm = _chol(torch.where(block, Ap, eye))  # L11 (+) I
    # rows past the rank: A21 L11^-T; the leading rows are L11 itself
    cols = torch.where(lead[:, None, :], Ap, 0.0)
    L21 = _solve_lower(Lm, cols.transpose(-1, -2)).transpose(-1, -2)
    L = torch.where(lead[:, :, None], torch.where(block, Lm, 0.0), L21)

    last = torch.clamp_min(rank - 1, 0)
    l_rr = torch.where(rank > 0, L[lanes, last, last], Ap[:, 0, 0])
    rank_f = rank.to(dtype)[:, None]
    synth = l_rr[:, None] * torch.exp(torch.lgamma(rank_f + 1.0) - torch.lgamma(idx.to(dtype) + 2.0))
    diag = torch.where(idx >= rank[:, None], synth, torch.diagonal(L, dim1=-2, dim2=-1))
    return torch.where(eye.bool(), torch.diag_embed(diag), L)


def cholesky_factor(K, nugget, nugget_type, reuse_factor=True, sparse_ladder=False,
                    progressive_ok=True, jitter_mask=None):
    """Factorize ``K`` by nugget type.

    :param K: ``(..., n, n)`` covariance without nugget.
    :param nugget: ``(...)`` nugget (ignored for ``"adaptive"``).
    :param nugget_type: ``"adaptive"``, ``"pivot"``, ``"fit"`` or
        ``"fixed"``.
    :param reuse_factor, sparse_ladder, progressive_ok: passed to
        :func:`jit_cholesky` for ``"adaptive"``.
    :param jitter_mask: ``(..., n)`` 0/1: the jitter (``"adaptive"``) or
        the nugget (``"fit"``, ``"fixed"``) goes on ``diag(mask)`` only
        (:func:`jit_cholesky`); not taken with ``"pivot"``.
    :returns: ``(factor, nugget)``: a ``ChoFactor`` (a
        ``PivotedChoFactor`` for ``"pivot"``) and the realized nugget.
    """
    if nugget_type == "adaptive":
        return jit_cholesky(K, reuse_factor=reuse_factor, sparse_ladder=sparse_ladder,
                            progressive_ok=progressive_ok, jitter_mask=jitter_mask)
    if nugget_type == "pivot":
        if jitter_mask is not None:
            raise ValueError("jitter_mask is not supported with the pivoted factorization")
        return pivoted_cholesky(K), nugget
    if nugget_type in ("fit", "fixed"):
        eye = _jitter_eye(K.shape[-1], jitter_mask, K.dtype, K.device)
        nugget = torch.as_tensor(nugget, dtype=K.dtype, device=K.device)
        return ChoFactor(fixed_cholesky(K + nugget[..., None, None] * eye)), nugget
    raise ValueError("Bad value for nugget_type in cholesky_factor")
