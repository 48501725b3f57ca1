"""Dimension reduction by gradient kernel dimension reduction (gKDR).

Port of ``mogp_tpu/uq/dimension_reduction.py`` (gKDR of Fukumizu & Leng,
reference ``mogp_emulator/DimensionReduction.py``).  The Gram matrices,
the host helpers and the parameter search are as in the JAX package; the
projection (:func:`_gkdr_projection`) runs on the card unless ``device=
"cpu"``, step by step:

* the Grams ``Kx`` and ``Ky``: ``UniformSqExp().kernel_f_predict`` at
  ``exp(theta) = 1 / sigma^2``, the same function as ``exp(-|z - z'|^2 /
  (2 sigma^2))``: K1 (``ops/kernel_matrix.py``) on a CUDA tensor;
* the factor of ``Kx + N EPS I``: ``ops/cholesky.py::fixed_cholesky``, no
  jitter ladder: K2 up to n = 240 in float64, the blocked route above;
* ``F = (Kx + N EPS I)^-1 Ky (Kx + N EPS I)^-1`` by triangular solves,
  ``R = sum_i H[i]^T F H[i]`` with ``H[i, j, m] = (X[i, m] - X[j, m]) /
  sigma_x^2 Kx[i, j]`` as two matrix products, and ``eigh(R)`` sorted
  descending: library calls, as ``mogp_tpu`` leaves them to XLA.

Everything runs in float64, on the card too: ``EPS = 1e-8`` puts ``N EPS``
(3e-6 at N = 300) below float32's resolution of ``Kx``'s spectrum, and
``mogp_tpu`` asks for float64 as well.  The H100's FP64 is native, and K1,
K2 and the blocked route take float64.  ``H`` is materialized, ``(N, N,
M)``: 14 MB at N = 300, M = 20.

Where ``Kx + N EPS I`` does not factor, ``B`` and ``evals`` are all NaN,
as in ``mogp_tpu``.
"""

import sys

import numpy as np
import torch
from scipy.spatial.distance import cdist, pdist, squareform

from ..config import resolve_device
from ..ops.cholesky import fixed_cholesky
from ..ops.kernels import UniformSqExp
from ..utils.misc import k_fold_cross_validation

__all__ = ["gram_matrix", "gram_matrix_sqexp", "median_dist", "gKDR"]


def gram_matrix(X, k):
    """Gram matrix under an arbitrary kernel callable
    (``DimensionReduction.py:77-93``)."""
    return cdist(X, X, k)


def gram_matrix_sqexp(X, sigma2):
    """Gram matrix under the squared-exponential kernel
    (``DimensionReduction.py:94-113``)."""
    return np.exp(-0.5 * squareform(pdist(X, "sqeuclidean")) / sigma2)


def median_dist(X):
    """Median pairwise Euclidean distance (``DimensionReduction.py:114-119``)."""
    return np.median(pdist(X))


def _grams(X, Y, SGX2, SGY2):
    """``Kx`` and ``Ky`` ``(N, N)``: the squared-exponential Grams at
    variances ``SGX2`` and ``SGY2``, through ``kernel_f_predict``."""
    sqexp = UniformSqExp()
    Kx = sqexp.kernel_f_predict(X, X, X.new_tensor([-np.log(SGX2)]))
    Ky = sqexp.kernel_f_predict(Y, Y, Y.new_tensor([-np.log(SGY2)]))
    return Kx, Ky


def _factor(Kx, EPS):
    """Lower Cholesky factor of ``Kx + N EPS I``; all NaN where it does not
    factor."""
    N = Kx.shape[0]
    return fixed_cholesky(Kx + (N * EPS) * torch.eye(N, dtype=Kx.dtype, device=Kx.device))


def _solves(L, Ky):
    """``F = A^-1 Ky A^-1`` for ``A = L L^T``, by four triangular solves."""
    def cho_solve(b):
        y = torch.linalg.solve_triangular(L, b, upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)

    return cho_solve(cho_solve(Ky).T).T


def _contraction(X, Kx, F, SGX2):
    """``R = sum_i H[i]^T F H[i]`` ``(M, M)``: ``F`` times ``H`` as ``(N,
    N M)``, then the sum over ``(N^2, M)`` as one product."""
    N, M = X.shape
    H = (X[:, None, :] - X[None, :, :]) / SGX2 * Kx[:, :, None]
    FH = (F @ H.reshape(N, N * M)).reshape(N * N, M)
    return H.reshape(N * N, M).T @ FH


def _eig(R):
    """Eigenvectors and eigenvalues of the symmetric ``R``, descending."""
    evals, V = torch.linalg.eigh(R)
    return V.flip(-1), evals.flip(-1)


@torch.no_grad()
def _gkdr_projection(X, Y, SGX2, SGY2, EPS):
    """Eigenvectors ``B`` ``(M, M)`` and eigenvalues ``(M,)`` of the gKDR
    ``R`` matrix (``DimensionReduction.py:200-229``) for ``X`` ``(N, M)``
    and ``Y`` ``(N, 1)`` float64 tensors."""
    Kx, Ky = _grams(X, Y, SGX2, SGY2)
    L = _factor(Kx, EPS)
    if not bool(torch.isfinite(L).all()):
        M = X.shape[1]
        nan = torch.full((M,), float("nan"), dtype=X.dtype, device=X.device)
        return nan.expand(M, M).clone(), nan
    F = _solves(L, Ky)
    return _eig(_contraction(X, Kx, F, SGX2))


class gKDR:
    """gKDR projection object (``DimensionReduction.py:121-250``).

    Callable: maps ``(N, M)`` inputs to the reduced ``(N, K)`` space via
    ``X @ B[:, :K]``.  The projection is computed on ``device`` (default
    the card) in float64; ``B`` and ``evals`` are float64 numpy arrays.
    """

    def __init__(self, X, Y, K=None, X_scale=1.0, Y_scale=1.0, EPS=1e-8,
                 SGX=None, SGY=None, device=None):
        X = np.asarray(X, dtype=np.float64)
        N, M = X.shape
        if K is None:
            K = M
        assert 0 <= K <= M
        assert EPS >= 0
        assert SGX is None or SGX > 0.0
        assert SGY is None or SGY > 0.0

        Y = np.reshape(np.asarray(Y, dtype=np.float64), (N, 1))

        SGX = X_scale * median_dist(X) if SGX is None else SGX
        SGY = Y_scale * median_dist(Y) if SGY is None else SGY

        SGX2 = max(SGX * SGX, sys.float_info.min)
        SGY2 = max(SGY * SGY, sys.float_info.min)

        device = resolve_device(device)
        B, evals = _gkdr_projection(
            torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device),
            SGX2, SGY2, float(EPS),
        )

        self.X_scale = X_scale
        self.Y_scale = Y_scale
        self.K = K
        self.B = B.cpu().numpy()
        self.evals = evals.cpu().numpy()

    def __call__(self, X):
        """Map inputs to the reduced space (``DimensionReduction.py:238-249``)."""
        return np.asarray(X) @ self.B[:, 0 : self.K]

    @staticmethod
    def _compute_loss(X, Y, train_model, cross_validation_folds, *params,
                      **kwparams):
        """Cross-validated L1 loss of a model on gKDR-reduced inputs
        (``DimensionReduction.py:252-306``)."""
        XY = np.hstack((X, Y[:, np.newaxis]))
        fold_losses = []
        for fold_train, fold_val in k_fold_cross_validation(
            XY, cross_validation_folds
        ):
            tr, va = np.array(fold_train), np.array(fold_val)
            dr = gKDR(tr[:, :-1], tr[:, -1], *params, **kwparams)
            model = train_model(dr(tr[:, :-1]), tr[:, -1])
            fold_losses.append(
                np.mean(np.abs(va[:, -1] - model(dr(va[:, :-1]))))
            )
        return np.mean(fold_losses)

    @classmethod
    def tune_parameters(cls, X, Y, train_model, cXs=None, cYs=None, maxK=None,
                        cross_validation_folds=5, verbose=False, device=None):
        """Grid/doubling search over (X_scale, Y_scale, K) minimizing
        cross-validated L1 loss (``DimensionReduction.py:309-456``); every
        gKDR runs on ``device``."""
        X = np.asarray(X)
        Y = np.asarray(Y)
        N, M = X.shape
        default_scales = (0.5, 1.0, 5.0)
        cXs = list(default_scales) if cXs is None else cXs
        cYs = list(default_scales) if cYs is None else cYs
        maxK = M if maxK is None else maxK
        assert 1 <= maxK <= M

        # K ladder: 1, 2, 4, ... capped at maxK (DimensionReduction.py:421-449)
        k_ladder = []
        k = 1
        while k < maxK:
            k_ladder.append(k)
            k *= 2
        k_ladder.append(maxK)

        min_loss, argmin_loss = np.inf, None
        for cX in cXs:
            for cY in cYs:
                prev_loss = np.inf
                for k in k_ladder:
                    loss = gKDR._compute_loss(
                        X, Y, train_model, cross_validation_folds, k, cX, cY,
                        device=device,
                    )
                    if verbose:
                        print(
                            "loss(K={}, X_scale={}, Y_scale={}) = {}".format(
                                k, cX, cY, loss
                            )
                        )
                    if loss < min_loss:
                        min_loss, argmin_loss = loss, (k, cX, cY)
                    if loss > prev_loss:
                        break  # loss rising along the K ladder: stop early
                    prev_loss = loss

        dr = gKDR(X, Y, *argmin_loss, device=device)
        return (dr, min_loss)
