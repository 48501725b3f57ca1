"""Fused, lane-batched kernel-matrix build: the CUDA kernel and its plain version.

Port of ``mogp_tpu/ops/pallas_kernels.py``.  :func:`kernel_matrix`
computes ``sigma2[l] * k(r2)`` for every output lane ``l``, training row
and query point, where ``r2`` is the scaled squared distance and ``k`` is
the squared exponential or Matern-5/2 function of ``ops/kernels.py``.

* On a CUDA tensor it launches K1, ``mogp_kernel_matrix`` of
  ``csrc/kernel_matrix.cu`` (built at first use by ``ops/_build.py``), and
  adds one to :data:`launches`.  It does not catch build or launch errors
  and never falls back to the plain version.
* On a CPU tensor it calls :func:`kernel_matrix_plain`, which is what the
  CPU tests run.

Prediction with a stationary or uniform kernel and no full covariance goes
through ``ops/predict_fused.py`` instead, which builds the same tiles with
the same device function and never writes them out; K1 serves the rest.
"""

import torch

__all__ = ["kernel_matrix", "kernel_matrix_plain", "launches"]

# launches of the CUDA kernel in this process; callers may reset it
launches = 0

_BASES = {"sqexp": 0, "mat52": 1}
_MAX_ROWS_PER_BLOCK = 56  # the smaller kK1MaxRows in csrc/kernel_matrix.cu
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1


def kernel_matrix_plain(x1, x2, exp_theta, sigma2, base="sqexp"):
    """``sigma2 * base(squared_distance(x1, x2, exp_theta))`` in plain torch.

    Same semantics as ``mogp_tpu/ops/pallas_kernels.py:105-118``, batched
    over the leading lanes axis: ``x1`` (L, n, D), ``x2`` (m, D),
    ``exp_theta`` (L, D), ``sigma2`` (L,); returns (L, n, m).
    """
    from .kernels import _BASE_FNS, squared_distance

    r2 = squared_distance(x1, x2, exp_theta)
    return sigma2[:, None, None] * _BASE_FNS[base](r2)


def _check(x1, x2, exp_theta, sigma2, base):
    if base not in _BASES:
        raise ValueError("base must be one of {}, got {!r}".format(list(_BASES), base))
    args = {"x1": x1, "x2": x2, "exp_theta": exp_theta, "sigma2": sigma2}
    for name, t in args.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError("{} must be a torch.Tensor".format(name))
        if t.device != x1.device:
            raise ValueError(
                "{} is on {}, x1 on {}".format(name, t.device, x1.device)
            )
        if t.dtype != x1.dtype:
            raise TypeError("{} is {}, x1 is {}".format(name, t.dtype, x1.dtype))
        if not t.is_contiguous():
            raise ValueError("{} must be contiguous".format(name))
    if x1.dtype not in (torch.float32, torch.float64):
        raise TypeError("kernel_matrix takes float32 or float64, got {}".format(x1.dtype))
    if x1.ndim != 3:
        raise ValueError("x1 must be (L, n, D), got {}".format(tuple(x1.shape)))
    L, n, D = x1.shape
    if x2.ndim != 2 or x2.shape[1] != D:
        raise ValueError("x2 must be (m, {}), got {}".format(D, tuple(x2.shape)))
    if tuple(exp_theta.shape) != (L, D):
        raise ValueError(
            "exp_theta must be ({}, {}), got {}".format(L, D, tuple(exp_theta.shape))
        )
    if tuple(sigma2.shape) != (L,):
        raise ValueError("sigma2 must be ({},), got {}".format(L, tuple(sigma2.shape)))


def kernel_matrix(x1, x2, exp_theta, sigma2, base="sqexp"):
    """Kernel matrices ``(L, n, m)`` for ``L`` lanes; see the module doc.

    :param x1: ``(L, n, D)`` training inputs, one set per lane.
    :param x2: ``(m, D)`` query points shared by all lanes.
    :param exp_theta: ``(L, D)`` per-lane scales ``exp(theta)``.
    :param sigma2: ``(L,)`` per-lane covariance scale.
    :param base: ``"sqexp"`` or ``"mat52"``.
    """
    _check(x1, x2, exp_theta, sigma2, base)
    if x1.device.type == "cpu":
        return kernel_matrix_plain(x1, x2, exp_theta, sigma2, base)
    if x1.device.type != "cuda":
        raise ValueError("kernel_matrix runs on CPU or CUDA, not {}".format(x1.device))

    L, n, D = x1.shape
    m = x2.shape[0]
    out = torch.empty((L, n, m), dtype=x1.dtype, device=x1.device)
    if out.numel() == 0:
        return out
    if L > _MAX_GRID_YZ or -(-n // _MAX_ROWS_PER_BLOCK) > _MAX_GRID_YZ:
        raise ValueError("kernel_matrix grid too large for L={}, n={}".format(L, n))
    if max(n, m, D) > _MAX_INT:
        raise ValueError("kernel_matrix sizes must fit in a 32-bit int")

    from ._build import KernelError, count_lock, library

    lib = library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mogp_kernel_matrix(
            x1.data_ptr(), x2.data_ptr(), exp_theta.data_ptr(),
            sigma2.data_ptr(), out.data_ptr(),
            L, n, m, D, _BASES[base], int(x1.dtype == torch.float64), stream,
        )
    if err:
        raise KernelError(
            "kernel_matrix launch failed: {}".format(
                lib.mogp_cuda_error_string(err).decode()
            )
        )
    global launches
    with count_lock:
        launches += 1
    return out
