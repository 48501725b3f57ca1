"""Batched small-matrix Cholesky (K2): the CUDA kernel and its plain version.

Port of ``tools/pallas_cholesky_experiment.py::cholesky_batched``.
:func:`cholesky_batched` factors ``(B, n, n) -> (B, n, n)`` lower, upper
triangle zero; a matrix that is not positive definite comes out all NaN
and leaves the other matrices untouched.  It is the Cholesky of the MAP
fit: every objective evaluation factors (lanes x ladder rungs) matrices of
the training size, and the refit and the mean algebra go through it too.

* On a CUDA tensor it launches ``csrc/cholesky_batched.cu`` (built at first
  use by ``ops/_build.py``) and adds one to :data:`launches`.  It does not
  catch build or launch errors and never falls back to the plain version.
* On a CPU tensor it calls :func:`cholesky_batched_plain`, which is what
  the CPU tests run.
* **Two paths in the kernel, one launch either way.**  While the packed
  lower triangle, ``n (n + 1) / 2`` elements, fits in one block's shared
  memory (:data:`MAX_SHARED_BYTES`: n <= 340 in float32, n <= 240 in
  float64, :func:`max_shared_n`), the matrix is factored there.  Larger
  matrices are factored by the same column loop in device memory, with no
  bound on n.
* ``n = 0`` or an empty batch returns an empty factor without a launch.
"""

import math

import torch

__all__ = [
    "cholesky_batched",
    "cholesky_batched_plain",
    "max_shared_n",
    "MAX_SHARED_BYTES",
    "launches",
]

# launches of the CUDA kernel in this process; callers may reset it
launches = 0

# dynamic shared memory one block may opt into on Hopper (227 KB): the
# largest packed triangle the kernel's shared-memory path holds
MAX_SHARED_BYTES = 232_448

_MAX_INT = 2**31 - 1


def max_shared_n(dtype):
    """Largest n whose packed lower triangle fits :data:`MAX_SHARED_BYTES`:
    the kernel's shared-memory path; larger n take its device-memory path."""
    words = MAX_SHARED_BYTES // (torch.finfo(dtype).bits // 8)
    return (math.isqrt(8 * words + 1) - 1) // 2


def cholesky_batched_plain(A):
    """``torch.linalg.cholesky_ex`` with every lane whose ``info`` is not 0
    set to NaN: the kernel's contract in plain torch."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, torch.nan))


def _check(A):
    if not isinstance(A, torch.Tensor):
        raise TypeError("A must be a torch.Tensor")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError("cholesky_batched takes float32 or float64, got {}".format(A.dtype))
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError("A must be (B, n, n), got {}".format(tuple(A.shape)))
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if A.shape[0] > _MAX_INT:
        raise ValueError("cholesky_batched batch must fit in a 32-bit int")


def cholesky_batched(A):
    """Lower Cholesky factors of ``A`` ``(B, n, n)``; see the module doc."""
    _check(A)
    B, n, _ = A.shape
    if B == 0 or n == 0:
        return torch.empty_like(A)
    if A.device.type == "cpu":
        return cholesky_batched_plain(A)
    if A.device.type != "cuda":
        raise ValueError("cholesky_batched runs on CPU or CUDA, not {}".format(A.device))

    from ._build import library

    lib = library()
    out = torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mogp_cholesky_batched(
            A.data_ptr(), out.data_ptr(), B, n, int(A.dtype == torch.float64),
            int(n <= max_shared_n(A.dtype)), stream,
        )
    if err:
        raise RuntimeError(
            "cholesky_batched launch failed: {}".format(lib.mogp_cuda_error_string(err).decode())
        )
    global launches
    launches += 1
    return out
