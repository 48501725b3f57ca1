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
  (128-column panels, three launches each, plus one copy in and one NaN
  pass out; built at first use by ``ops/_build.py``) and adds one to
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
* The variants compute the same factor in other orders: rank-1 panel
  steps (v1), rank-8 micro-panels (v2), 16-column micro-panels through the
  Newton inverse of their diagonal tile (v3).  Unlike the JAX v3, the port's
  v3 takes float64 too.
"""

import torch

from .cholesky_batched import check_square_batch, cholesky_batched_plain, cholesky_plain_ex

__all__ = ["cholesky_blocked", "cholesky_blocked_ex", "cholesky_blocked_plain", "VARIANTS",
           "PANEL", "launches"]

VARIANTS = ("v1", "v2", "v3")

# launches (panel loops) of each variant in this process; callers may reset them
launches = {v: 0 for v in VARIANTS}

# panel width and inverse-tile width of csrc/cholesky_blocked.cu (v3's scratch)
PANEL, _MB3 = 128, 16

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

    from ._build import library

    lib = library()
    out = torch.empty_like(A)
    status = torch.zeros(B, dtype=torch.int32, device=A.device)
    inv = torch.empty(B, PANEL, _MB3, dtype=A.dtype, device=A.device) if variant == "v3" else None
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mogp_cholesky_blocked(
            A.data_ptr(), out.data_ptr(), status.data_ptr(),
            None if inv is None else inv.data_ptr(), B, n, int(A.dtype == torch.float64),
            VARIANTS.index(variant) + 1, stream,
        )
    if err:
        raise RuntimeError(
            "cholesky_blocked launch failed: {}".format(lib.mogp_cuda_error_string(err).decode())
        )
    launches[variant] += 1
    return out, status
