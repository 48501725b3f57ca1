"""Stationary covariance kernels on torch tensors.

Port of ``mogp_tpu/ops/kernels.py``.  Every function broadcasts over
leading batch axes, so the same code builds one kernel matrix or one per
output lane:

* ``x1`` ``(..., n, D)`` and ``x2`` ``(..., m, D)`` or ``(m, D)``;
* raw parameters ``(..., P)``.

The scaled squared distance is computed in matmul form
``|z1|^2 + |z2|^2 - 2 z1 z2^T`` with ``z = x * exp(theta/2)``, clamped at
zero, as in the JAX package; a training covariance's (``K(x, x)``) is
corrected to an exact zero diagonal (:func:`squared_distance`).  Matmuls run in full float32 or float64:
``mogp_tpu_torch.config`` switches TF32 off when the package is imported.

``kernel_deriv`` and ``kernel_hessian`` differentiate :meth:`KernelBase.kernel_f`
in forward mode (``torch.func.jacfwd``), as the JAX package does with
``jax.jacfwd``; neither reaches a CUDA kernel.
"""

import torch

from .kernel_matrix import kernel_matrix

__all__ = [
    "KernelBase",
    "SquaredExponential",
    "UniformSqExp",
    "Matern52",
    "UniformMat52",
    "ProductMat52",
    "sqexp",
    "mat52",
    "squared_distance",
    "get_kernel",
]


def sqexp(r2):
    """Squared-exponential kernel function ``K = exp(-r2/2)``."""
    return torch.exp(-0.5 * r2)


def mat52(r2):
    """Matern-5/2 ``K = (1 + sqrt(5 r2) + 5/3 r2) exp(-sqrt(5 r2))``.

    The double ``where`` keeps K exactly 1 at ``r2 = 0`` and keeps autograd
    finite there (the sqrt has an infinite slope at zero).
    """
    pos = r2 > 0.0
    safe_r2 = torch.where(pos, r2, torch.ones_like(r2))
    r = torch.sqrt(5.0 * safe_r2)
    k = (1.0 + r + (5.0 / 3.0) * safe_r2) * torch.exp(-r)
    return torch.where(pos, k, torch.ones_like(k))


_BASE_FNS = {"sqexp": sqexp, "mat52": mat52}


def squared_distance(x1, x2, exp_theta):
    """All-pairs scaled squared distance in matmul form, clamped at zero.

    When ``x2 is x1`` (a training covariance), an entry no larger than its
    row's or its column's diagonal entry, which is 0 in exact arithmetic,
    is set to 0: the diagonal, and the distance of two equal inputs (whose
    entries equal their diagonal's).  The matmul form cancels ``|z_i|^2 +
    |z_j|^2`` against ``2 z_i . z_j``, with an error of a few ulps of
    ``|z|^2``: at correlation lengths of ~1e-2 in unit inputs (``|z|^2`` ~
    1e5) that is ~1e-2 in float32, which on the diagonal would scale every
    ``K_ii`` by ~0.995 and move the predictive mean at a training input by
    as much.

    :param x1: ``(..., n1, D)``.
    :param x2: ``(..., n2, D)``.
    :param exp_theta: ``(..., D)`` per-dimension scales, or ``(..., 1)``
        for one shared scale.
    :returns: ``(..., n1, n2)``.
    """
    scale = torch.sqrt(exp_theta).unsqueeze(-2)
    z1 = x1 * scale
    z2 = x2 * scale
    sq1 = torch.sum(z1 * z1, dim=-1)
    sq2 = torch.sum(z2 * z2, dim=-1)
    cross = z1 @ z2.transpose(-1, -2)
    r2 = sq1[..., :, None] + sq2[..., None, :] - 2.0 * cross
    if x2 is x1:
        diag = torch.diagonal(r2, dim1=-2, dim2=-1)
        floor = torch.maximum(diag[..., :, None], diag[..., None, :])
        r2 = torch.where(r2 <= floor, torch.zeros_like(r2), r2)
    return torch.clamp_min(r2, 0.0)


def _product_kernel_matrix(x1, x2, raw_params, base_fn):
    """Per-dimension kernel product: the base kernel of each dimension's
    scaled squared distance, multiplied across dimensions.  A loop over D
    keeps peak memory at one ``(..., n1, n2)`` matrix."""
    exp_theta = torch.exp(raw_params)
    prod = None
    for d in range(x1.shape[-1]):
        r2_d = exp_theta[..., d, None, None] * (x1[..., :, None, d] - x2[..., None, :, d]) ** 2
        k = base_fn(r2_d)
        prod = k if prod is None else prod * k
    return prod


class KernelBase:
    """Static kernel descriptor.

    ``base`` is the kernel function (``"sqexp"`` or ``"mat52"``); ``form``
    the distance form: ``"stationary"`` (one length per input dimension),
    ``"uniform"`` (one shared length) or ``"product"`` (per-dimension
    kernel values multiplied).  Instances carry no data and are hashable.
    """

    base = "sqexp"
    form = "stationary"

    def get_n_params(self, inputs):
        """Number of correlation-length parameters for ``(..., n, D)`` inputs."""
        if self.form == "uniform":
            return 1
        assert inputs.ndim >= 2, "Inputs must be a 2D array"
        return inputs.shape[-1]

    def kernel_f(self, x1, x2, params):
        """Kernel matrix ``K(x1, x2)`` for raw parameters ``params``."""
        x1, x2, params = self._coerce(x1, x2, params)
        base_fn = _BASE_FNS[self.base]
        if self.form == "product":
            return _product_kernel_matrix(x1, x2, params, base_fn)
        return base_fn(squared_distance(x1, x2, torch.exp(params)))

    def kernel_f_predict(self, x1, x2, params, sigma2=None):
        """``sigma2 * K(x1, x2)`` for paths that are not differentiated.

        Stationary and uniform forms go through the fused kernel
        (``ops/kernel_matrix.py``), which takes lanes: ``params`` ``(L, P)``
        with ``x1`` ``(L, n, D)`` or a shared ``(n, D)``; ``x2`` ``(m, D)``;
        ``sigma2`` ``(L,)``.  Unbatched ``params`` ``(P,)`` with ``x1``
        ``(n, D)`` and a scalar or absent ``sigma2`` give ``(n, m)``.
        The product form stays on :meth:`kernel_f`.
        """
        if self.form == "product":
            x1, x2, params = self._coerce(x1, x2, params)
            K = self.kernel_f(x1, x2, params)
            if sigma2 is None:
                return K
            return torch.as_tensor(sigma2, dtype=x1.dtype, device=x1.device)[..., None, None] * K
        lanes = torch.as_tensor(params).ndim == 2
        K = kernel_matrix(*self.lane_inputs(x1, x2, params, sigma2), base=self.base)
        return K if lanes else K[0]

    def lane_inputs(self, x1, x2, params, sigma2=None):
        """The inputs of the fused kernels (``ops/kernel_matrix.py``,
        ``ops/predict_fused.py``) for a stationary or uniform form:
        ``(x1 (L, n, D), x2 (m, D), exp_theta (L, D), sigma2 (L,))``, all
        contiguous; arguments as :meth:`kernel_f_predict` takes them."""
        x1, x2, params = self._coerce(x1, x2, params)
        if params.ndim == 1:
            params = params[None]
            x1 = x1[None]
        L, D = params.shape[0], x1.shape[-1]
        x1 = x1.expand(L, *x1.shape[-2:]).contiguous()
        exp_theta = torch.exp(params)
        if self.form == "uniform":
            exp_theta = exp_theta[:, :1].expand(L, D)
        if sigma2 is None:
            sigma2 = torch.ones(L, dtype=x1.dtype, device=x1.device)
        sigma2 = torch.as_tensor(sigma2, dtype=x1.dtype, device=x1.device)
        return x1, x2.contiguous(), exp_theta.contiguous(), sigma2.reshape(L).contiguous()

    def calc_r2(self, x1, x2, params):
        """Scaled squared distances; the product form returns the
        per-dimension distances ``(..., D, n1, n2)``."""
        x1, x2, params = self._coerce(x1, x2, params)
        exp_theta = torch.exp(params)
        if self.form == "product":
            d2 = (x1[..., :, None, :] - x2[..., None, :, :]) ** 2 * exp_theta[..., None, None, :]
            return torch.movedim(d2, -1, -3)
        return squared_distance(x1, x2, exp_theta)

    def kernel_deriv(self, x1, x2, params):
        """Gradient of the kernel matrix with respect to the raw parameters,
        ``(P, n1, n2)`` with the parameter axis first, by forward mode.

        With ``x2`` the same array as ``x1`` the diagonal's distance is an
        exact zero (:func:`squared_distance`), so its derivative is exactly
        0 in any type, and ``mat52``'s double ``where`` keeps it finite."""
        x1, x2, params = self._coerce(x1, x2, params)
        jac = torch.func.jacfwd(lambda p: self.kernel_f(x1, x2, p))(params)
        return torch.movedim(jac, -1, 0)

    def kernel_hessian(self, x1, x2, params):
        """Hessian of the kernel matrix with respect to the raw parameters,
        ``(P, P, n1, n2)``, by forward mode over forward mode."""
        x1, x2, params = self._coerce(x1, x2, params)
        hess = torch.func.jacfwd(torch.func.jacfwd(lambda p: self.kernel_f(x1, x2, p)))(params)
        return torch.movedim(hess, (-2, -1), (0, 1))

    def _coerce(self, x1, x2, params):
        # the same array twice stays one tensor: squared_distance zeroes the
        # diagonal of a training covariance by that identity
        same = x2 is x1
        x1 = torch.as_tensor(x1)
        x2 = x1 if same else torch.as_tensor(x2, dtype=x1.dtype, device=x1.device)
        params = torch.as_tensor(params, dtype=x1.dtype, device=x1.device)
        if params.ndim == 0:
            params = params.reshape(1)
        if self.form == "uniform":
            if x1.ndim == 1:
                x1 = x1.reshape(-1, 1)
            if x2.ndim == 1:
                x2 = x2.reshape(-1, 1)
            x2 = x1 if same else x2
            assert params.shape[-1] == 1, (
                "Uniform kernels only support a single correlation length"
            )
        else:
            D = params.shape[-1]
            if x1.ndim == 1:
                x1 = x1.reshape(-1, 1) if D == 1 else x1.reshape(1, D)
            if x2.ndim == 1:
                x2 = x2.reshape(-1, 1) if D == 1 else x2.reshape(1, D)
            x2 = x1 if same else x2
            assert x1.shape[-1] == D and x2.shape[-1] == D, "bad shape for inputs"
        assert x1.shape[-1] == x2.shape[-1]
        return x1, x2, params

    def __hash__(self):
        return hash((type(self).__name__, self.base, self.form))

    def __eq__(self, other):
        return (
            isinstance(other, KernelBase)
            and self.base == other.base
            and self.form == other.form
        )

    def __repr__(self):
        return type(self).__name__ + "()"


class SquaredExponential(KernelBase):
    """Per-dimension-lengthscale squared exponential."""

    base, form = "sqexp", "stationary"

    def __str__(self):
        return "Squared Exponential Kernel"


class UniformSqExp(KernelBase):
    """Single-lengthscale squared exponential."""

    base, form = "sqexp", "uniform"

    def __str__(self):
        return "Squared Exponential Kernel"


class Matern52(KernelBase):
    """Per-dimension-lengthscale Matern 5/2."""

    base, form = "mat52", "stationary"

    def __str__(self):
        return "Matern 5/2 Kernel"


class UniformMat52(KernelBase):
    """Single-lengthscale Matern 5/2."""

    base, form = "mat52", "uniform"

    def __str__(self):
        return "Matern 5/2 Kernel"


class ProductMat52(KernelBase):
    """Product-form Matern 5/2."""

    base, form = "mat52", "product"

    def __str__(self):
        return "Product Matern 5/2 Kernel"


_KERNELS = {
    "SquaredExponential": SquaredExponential,
    "UniformSqExp": UniformSqExp,
    "Matern52": Matern52,
    "UniformMat52": UniformMat52,
    "ProductMat52": ProductMat52,
}


def get_kernel(kernel):
    """Resolve a kernel argument (object or name string) to a descriptor."""
    if isinstance(kernel, KernelBase):
        return kernel
    if isinstance(kernel, str):
        try:
            return _KERNELS[kernel]()
        except KeyError:
            raise ValueError(
                "provided kernel '{}' not a supported kernel type".format(kernel)
            )
    raise ValueError("provided kernel is not a subclass of KernelBase")
