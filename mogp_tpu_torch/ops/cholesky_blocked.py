"""Blocked batched Cholesky (K3, K4, K5): the CUDA kernels and their plain version.

Port of ``tools/exp_chol.py``'s three blocked experiments, ``chol_blocked``
(``"v1"``, K3), ``chol_blocked_v2`` (``"v2"``, K4) and ``chol_blocked_v3``
(``"v3"``, K5).  :func:`cholesky_blocked` factors ``(B, n, n) -> (B, n,
n)`` lower, upper triangle zero, with K2's contract: a matrix that is not
positive definite comes out all NaN and leaves the other matrices
untouched.  It takes the n above K2's shared-memory bound
(``cholesky_batched.route``): the large-n GP's progressive ladder and any
batched ladder above n = 340 (float32) / 240 (float64).

* On a CUDA tensor it runs the panel loop of ``csrc/cholesky_blocked.cu``
  (128-column panels, four launches each for v2, three for v1 and v3, plus
  one copy in and one NaN pass out; built at first use by
  ``ops/_build.py``) on the current stream, with a side stream of the
  library's own for the look-ahead, joined back before it returns, and adds one to
  ``launches[variant]``: one count per factorization, i.e. per panel loop.
  It does not catch build or launch errors and never falls back to the
  plain version.
* On a CPU tensor it calls :func:`cholesky_blocked_plain`, K2's plain
  version (``cholesky_ex`` with the ``info`` mask), which is what the CPU
  tests run.
* :func:`cholesky_blocked_ex` also returns ``info``, as ``cholesky_ex``
  does: per matrix 0, or the 1-based column of the pivot that failed (the
  panel loop stops a matrix there, so the FLOPs a failed factorization ran
  can be counted).
* The variants compute the same factor in other orders: v1 sweeps each
  panel, its diagonal block and the rows below together, with 128 rank-1
  steps in one launch (one barrier a column; each block of the launch holds
  the diagonal block and a tile of the rows in registers and factors the
  diagonal block again); v2 (the route) takes 32-column micro-panels with
  tensor-core products; v3 16-column micro-panels through the Newton
  inverse of their diagonal tile, in one launch per panel as v1, the
  micro-panels' rows and rank-16 updates on tensor cores.  All three share
  the trailing update on tensor cores (three TF32 passes in float32, DMMA
  in float64) and the look-ahead panel loop; ``csrc/cholesky_blocked.cu``
  says why.  Unlike the JAX v3, the port's v3 takes float64 too.
* :func:`tf32_round` and :func:`matmul_tf32` emulate the update's float32
  arithmetic on the CPU (``tests/test_torch_tf32_split.py``); no path of
  the port calls them.
"""

import torch

from .cholesky_batched import check_square_batch, cholesky_batched_plain, cholesky_plain_ex

__all__ = ["cholesky_blocked", "cholesky_blocked_ex", "cholesky_blocked_plain", "VARIANTS",
           "PANEL", "launches", "tf32_round", "matmul_tf32"]

VARIANTS = ("v1", "v2", "v3")

# launches (panel loops) of each variant in this process; callers may reset them
launches = {v: 0 for v in VARIANTS}

# panel width of csrc/cholesky_blocked.cu
PANEL = 128

cholesky_blocked_plain = cholesky_batched_plain


def cholesky_blocked(A, variant):
    """Lower Cholesky factors of ``A`` ``(B, n, n)`` by ``variant``
    (``"v1"``, ``"v2"`` or ``"v3"``); see the module doc."""
    return cholesky_blocked_ex(A, variant)[0]


def cholesky_blocked_ex(A, variant):
    """``(L, info)``: :func:`cholesky_blocked`'s factors and, per matrix,
    an int32 ``info``, 0 where it factored, else the 1-based column of the
    pivot that was not positive and finite."""
    if variant not in VARIANTS:
        raise ValueError("variant must be one of {}, got {!r}".format(VARIANTS, variant))
    check_square_batch(A)
    B, n, _ = A.shape
    if B == 0 or n == 0:
        return torch.empty_like(A), torch.zeros(B, dtype=torch.int32, device=A.device)
    if A.device.type == "cpu":
        return cholesky_plain_ex(A)
    if A.device.type != "cuda":
        raise ValueError("cholesky_blocked runs on CPU or CUDA, not {}".format(A.device))

    from ._build import KernelError, count_lock, library

    lib = library()
    out = torch.empty_like(A)
    status = torch.zeros(B, dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mogp_cholesky_blocked(
            A.data_ptr(), out.data_ptr(), status.data_ptr(), B, n,
            int(A.dtype == torch.float64), VARIANTS.index(variant) + 1, stream,
        )
    if err:
        raise KernelError(
            "cholesky_blocked launch failed: {}".format(lib.mogp_cuda_error_string(err).decode())
        )
    with count_lock:
        launches[variant] += 1
    return out, status


def tf32_round(x):
    """float32 ``x`` rounded as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, keeping 10 of the 23 mantissa bits (the sign and
    magnitude bits of a float are its int32 pattern, so adding half of the
    dropped 13 bits' range and clearing them rounds the magnitude).
    Infinities and NaNs pass through."""
    if x.dtype != torch.float32:
        raise TypeError("tf32_round takes float32, got {}".format(x.dtype))
    r = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def matmul_tf32(a, b, passes=3):
    """``a @ b`` of float32 tensors in the tensor-core arithmetic of the
    blocked update.  ``passes=3`` (the kernels' 3xTF32) splits each operand
    as ``hi = tf32(x)``, ``lo = tf32(x - hi)`` and sums ``lo hi' + hi lo' +
    hi hi'`` in float32: products of TF32 values are exact in float32, and
    the missing ``lo lo'`` is ~2^-22 of the product.  ``passes=1`` is one
    plain TF32 product, which no kernel of the port uses."""
    if passes not in (1, 3):
        raise ValueError("passes must be 1 or 3, got {!r}".format(passes))
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
