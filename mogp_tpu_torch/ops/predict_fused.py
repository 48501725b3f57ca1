"""Fused prediction: K1 redesigned so that K* never reaches device memory.

For every output lane and query point the predictive mean and variance of
``models/gp.py::_gp_predict_impl``,

    mu  = dmtest beta + K*^T alpha
    var = max(var_shift - |Lk^-1 K*|^2 + |LA^-1 (dmtest^T - Kinv_dm^T K*)|^2, 0)

(sums over the training and the mean axes), with ``K*`` the
cross-covariance of ``ops/kernel_matrix.py``.

* On a CUDA tensor :func:`predict_fused` launches the fused kernel of
  ``csrc/kernel_matrix.cu`` (built at first use by ``ops/_build.py``) and
  adds one to :data:`launches`, and to :data:`mean_launches` where the
  launch took the mean-term stage (``M > 0``).  It does not catch build
  or launch errors and never falls back to the plain version.
* On a CPU tensor it calls :func:`predict_fused_plain`, which is what the
  CPU tests run: K1's plain version, ``torch.linalg.solve_triangular`` and
  the reductions, the unfused chain itself.
* **The route.**  The kernel keeps one lane's ``n x 64`` tile, three strips
  of the factor and the mean terms in one block's shared memory
  (:func:`shared_bytes`), so it takes ``n <= N_FUSED[dtype]`` and ``M <=
  M_FUSED``; :func:`route` is that choice, the same on both devices.  Full
  covariance, the product form, and larger ``n`` or ``M`` go the unfused
  way: K1, then the triangular solves.
"""

import torch

from .kernel_matrix import _BASES, kernel_matrix_plain

__all__ = [
    "predict_fused",
    "predict_fused_plain",
    "route",
    "shared_bytes",
    "N_FUSED",
    "M_FUSED",
    "QUERIES_PER_BLOCK",
    "launches",
    "mean_launches",
]

# launches of the CUDA kernel in this process, and those of them that took
# the mean-term stage (M > 0); callers may reset them
launches = 0
mean_launches = 0

# dynamic shared memory one block may opt into on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448
QUERIES_PER_BLOCK = 64  # kQ in csrc/kernel_matrix.cu
_PANEL = 16             # kPanel
_DIM_CHUNK = 16         # kDimChunk

# the largest training size and number of mean terms the fused kernel
# takes: multiples of the panel inside MAX_SHARED_BYTES (225,536 bytes at
# (480, 32) in float32, 221,696 at (224, 32) in float64; shared_bytes)
N_FUSED = {torch.float32: 480, torch.float64: 224}
M_FUSED = 32

_MAX_GRID_Y = 65535
_MAX_INT = 2**31 - 1


def shared_bytes(n, M, dtype):
    """Dynamic shared memory of the fused kernel at ``n`` training points
    and ``M`` mean terms: the ``n x 64`` tile; the larger of the build's
    staging and three 16-column strips of the factor; ``r`` (``M x 64``);
    eight rows of partial sums and one of ``k . alpha``.
    ``csrc/kernel_matrix.cu::fused_smem_elems``."""
    q = QUERIES_PER_BLOCK
    stage = n * _DIM_CHUNK + q * (_DIM_CHUNK + 1)
    region = max(3 * max(n, _PANEL) * _PANEL, stage)
    elems = n * q + region + (max(M, 1) + 9) * q
    return elems * (torch.finfo(dtype).bits // 8)


def route(device, n, M, form, full_cov, dtype):
    """``"fused"`` or ``"unfused"``: how lanes of ``n`` training points,
    ``M`` mean terms and a kernel of distance ``form`` are predicted.

    The same rule on the CPU (where "fused" is :func:`predict_fused_plain`)
    and on the card; it depends on nothing else: no build or launch
    outcome, flag or environment variable.
    """
    if torch.device(device).type not in ("cpu", "cuda"):
        raise ValueError("prediction runs on CPU or CUDA, not {}".format(device))
    if full_cov or form not in ("stationary", "uniform") or dtype not in N_FUSED:
        return "unfused"
    return "fused" if 1 <= n <= N_FUSED[dtype] and M <= M_FUSED else "unfused"


def predict_fused_plain(x1, x2, exp_theta, sigma2, Lk, alpha, Kinv_dm, dmtest, beta, LA,
                        var_shift, unc=True, base="sqexp"):
    """The fused kernel's function in plain torch: ``(mu, var)``, ``var``
    ``None`` unless ``unc``; the unfused chain of ``_gp_predict_impl``."""
    K = kernel_matrix_plain(x1, x2, exp_theta, sigma2, base)
    mu = (dmtest @ beta[..., None])[..., 0] + (K.transpose(-1, -2) @ alpha[..., None])[..., 0]
    if not unc:
        return mu, None
    R = dmtest.T - Kinv_dm.transpose(-1, -2) @ K
    v = torch.linalg.solve_triangular(Lk, K, upper=False)
    u = torch.linalg.solve_triangular(LA, R, upper=False) if LA.shape[-1] else R
    var = torch.clamp_min(
        var_shift[:, None] - torch.sum(v**2, dim=-2) + torch.sum(u**2, dim=-2), 0.0
    )
    return mu, var


def _check(args, base):
    if base not in _BASES:
        raise ValueError("base must be one of {}, got {!r}".format(list(_BASES), base))
    x1 = args["x1"]
    for name, t in args.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError("{} must be a torch.Tensor".format(name))
        if t.device != x1.device:
            raise ValueError("{} is on {}, x1 on {}".format(name, t.device, x1.device))
        if t.dtype != x1.dtype:
            raise TypeError("{} is {}, x1 is {}".format(name, t.dtype, x1.dtype))
        if not t.is_contiguous():
            raise ValueError("{} must be contiguous".format(name))
    if x1.dtype not in (torch.float32, torch.float64):
        raise TypeError("predict_fused takes float32 or float64, got {}".format(x1.dtype))
    if x1.ndim != 3:
        raise ValueError("x1 must be (L, n, D), got {}".format(tuple(x1.shape)))
    L, n, D = x1.shape
    m = args["x2"].shape[0]
    M = args["dmtest"].shape[-1] if args["dmtest"].ndim == 2 else -1
    shapes = {
        "x2": (m, D), "exp_theta": (L, D), "sigma2": (L,), "Lk": (L, n, n), "alpha": (L, n),
        "Kinv_dm": (L, n, M), "dmtest": (m, M), "beta": (L, M), "LA": (L, M, M),
        "var_shift": (L,),
    }
    for name, shape in shapes.items():
        if tuple(args[name].shape) != shape:
            raise ValueError("{} must be {}, got {}".format(
                name, shape, tuple(args[name].shape)))
    return L, n, m, D, M


def predict_fused(x1, x2, exp_theta, sigma2, Lk, alpha, Kinv_dm, dmtest, beta, LA, var_shift,
                  unc=True, base="sqexp"):
    """Predictive means ``(L, m)`` and, if ``unc``, variances ``(L, m)``;
    see the module doc.

    :param x1: ``(L, n, D)`` training inputs; ``x2`` ``(m, D)`` queries.
    :param exp_theta: ``(L, D)`` scales ``exp(theta)``; ``sigma2`` ``(L,)``.
    :param Lk: ``(L, n, n)`` lower factor of K (+ nugget).
    :param alpha: ``(L, n)`` ``K^-1 (y - H beta)``.
    :param Kinv_dm: ``(L, n, M)`` ``K^-1 H``; ``dmtest`` ``(m, M)`` the
        queries' design matrix; ``beta`` ``(L, M)`` the mean coefficients;
        ``LA`` ``(L, M, M)`` the lower factor of ``A``.
    :param var_shift: ``(L,)`` ``sigma2`` plus the nugget where it counts.
    """
    args = dict(x1=x1, x2=x2, exp_theta=exp_theta, sigma2=sigma2, Lk=Lk, alpha=alpha,
                Kinv_dm=Kinv_dm, dmtest=dmtest, beta=beta, LA=LA, var_shift=var_shift)
    L, n, m, D, M = _check(args, base)
    if x1.device.type == "cpu":
        return predict_fused_plain(**args, unc=unc, base=base)
    if x1.device.type != "cuda":
        raise ValueError("predict_fused runs on CPU or CUDA, not {}".format(x1.device))
    if route(x1.device, n, M, "stationary", False, x1.dtype) != "fused":
        raise ValueError("predict_fused takes 1 <= n <= {} and M <= {} in {}, got n={}, "
                         "M={}".format(N_FUSED[x1.dtype], M_FUSED, x1.dtype, n, M))
    if L > _MAX_GRID_Y or max(m, D) > _MAX_INT:
        raise ValueError("predict_fused grid too large for L={}, m={}".format(L, m))

    mu = torch.empty((L, m), dtype=x1.dtype, device=x1.device)
    var = torch.empty((L, m), dtype=x1.dtype, device=x1.device) if unc else None
    if m == 0 or L == 0:
        return mu, var

    import ctypes

    from ._build import KernelError, count_lock, library

    lib = library()
    size = torch.finfo(x1.dtype).bits // 8
    if lib.mogp_predict_fused_smem(n, M, size) != shared_bytes(n, M, x1.dtype):
        raise KernelError("shared_bytes disagrees with csrc/kernel_matrix.cu")
    # the kernel copies the factor in 16-byte pieces: rows padded to ldl
    ldl = -(-n * size // 16) * 16 // size
    if ldl != n:
        args["Lk"] = torch.nn.functional.pad(Lk, (0, ldl - n))
    ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in args.values()])
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mogp_predict_fused(
            ptrs, mu.data_ptr(), 0 if var is None else var.data_ptr(), L, n, ldl, m, D, M,
            int(bool(unc)), _BASES[base], int(x1.dtype == torch.float64), stream,
        )
    if err:
        raise KernelError(
            "predict_fused launch failed: {}".format(lib.mogp_cuda_error_string(err).decode())
        )
    global launches, mean_launches
    with count_lock:
        launches += 1
        mean_launches += int(M > 0)
    return mu, var
