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
* **The route.**  K2 factors a matrix in one block's shared memory, so it
  takes n while the packed lower triangle, ``n (n + 1) / 2`` elements,
  fits :data:`MAX_SHARED_BYTES` (n <= 340 in float32, n <= 240 in
  float64, :func:`max_shared_n`).  Larger n go to the blocked
  factorization (``ops/cholesky_blocked.py``, variant
  :data:`BLOCKED_VARIANT`); :func:`route` is that choice, and
  :data:`launches` counts K2's launches only.
* ``n = 0`` or an empty batch returns an empty factor without a launch.
"""

import math

import torch

__all__ = [
    "cholesky_batched",
    "cholesky_batched_plain",
    "cholesky_plain_ex",
    "max_shared_n",
    "route",
    "BLOCKED_VARIANT",
    "MAX_SHARED_BYTES",
    "launches",
]

# launches of the CUDA kernel in this process; callers may reset it
launches = 0

# dynamic shared memory one block may opt into on Hopper (227 KB): the
# largest packed triangle the kernel's shared-memory path holds
MAX_SHARED_BYTES = 232_448

# the blocked variant that takes n above K2's bound: the fastest of the
# three at (1, 4096) float32 on an H100 (PERF.md, the K3-K5 timings)
BLOCKED_VARIANT = "v2"

_MAX_INT = 2**31 - 1


def max_shared_n(dtype):
    """Largest n whose packed lower triangle fits :data:`MAX_SHARED_BYTES`:
    the largest n K2 takes (:func:`route`)."""
    words = MAX_SHARED_BYTES // (torch.finfo(dtype).bits // 8)
    return (math.isqrt(8 * words + 1) - 1) // 2


def route(n, dtype):
    """The kernel that factors ``(B, n, n)`` matrices of ``dtype`` on the
    card: ``"k2"`` up to :func:`max_shared_n`, the blocked variant above."""
    return "k2" if n <= max_shared_n(dtype) else BLOCKED_VARIANT


def cholesky_plain_ex(A):
    """``torch.linalg.cholesky_ex`` with every lane whose ``info`` is not 0
    set to NaN, and ``info``: the Cholesky kernels' contract in plain
    torch."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, torch.nan)), info


def cholesky_batched_plain(A):
    """The factors of :func:`cholesky_plain_ex`."""
    return cholesky_plain_ex(A)[0]


def check_square_batch(A):
    """Raise unless ``A`` is a contiguous ``(B, n, n)`` float32 or float64
    tensor with ``B`` within a 32-bit int: what the Cholesky kernels take."""
    if not isinstance(A, torch.Tensor):
        raise TypeError("A must be a torch.Tensor")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError("the Cholesky kernels take float32 or float64, got {}".format(A.dtype))
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError("A must be (B, n, n), got {}".format(tuple(A.shape)))
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if A.shape[0] > _MAX_INT:
        raise ValueError("the batch must fit in a 32-bit int")


def cholesky_batched(A):
    """Lower Cholesky factors of ``A`` ``(B, n, n)``; see the module doc."""
    check_square_batch(A)
    B, n, _ = A.shape
    if B == 0 or n == 0:
        return torch.empty_like(A)
    if A.device.type == "cpu":
        return cholesky_batched_plain(A)
    if A.device.type != "cuda":
        raise ValueError("cholesky_batched runs on CPU or CUDA, not {}".format(A.device))

    kernel = route(n, A.dtype)
    if kernel != "k2":
        from .cholesky_blocked import cholesky_blocked

        return cholesky_blocked(A, kernel)

    from ._build import library

    lib = library()
    out = torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mogp_cholesky_batched(
            A.data_ptr(), out.data_ptr(), B, n, int(A.dtype == torch.float64), stream,
        )
    if err:
        raise RuntimeError(
            "cholesky_batched launch failed: {}".format(lib.mogp_cuda_error_string(err).decode())
        )
    global launches
    launches += 1
    return out
