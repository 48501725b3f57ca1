"""Gaussian Process emulator: functional core over lanes + reference-parity class.

Port of ``mogp_tpu/models/gp.py``.  Every function of the core takes a
leading lanes (outputs, or outputs x restarts) axis ``L`` where the JAX
package used ``vmap``:

* ``gp_fit``      -- fit-time artifacts and negative log posterior for
                     raw hyperparameters ``(L, P)``;
* ``gp_nlp``      -- the negative log posterior alone, the MAP objective,
                     differentiable by autograd;
* ``gp_predict``  -- predictive mean and (co)variance;
* ``gp_predict_tiled`` -- the same over fixed-size query tiles, so device
                     memory depends on the tile and not on the query count.

``GPData`` and ``FitArtifacts`` are NamedTuples of tensors that all carry
the lanes axis first; :func:`cat_lanes` stacks them and
:func:`take_lanes` slices them.  ``gp_fit`` and prediction build no
autograd graph; ``gp_nlp`` does, and ``GaussianProcess.logpost_deriv`` /
``logpost_hessian`` differentiate it.
"""

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..ops.cholesky import ChoFactor, cholesky_factor
from ..ops import predict_fused as pf
from ..ops.kernels import get_kernel
from ..ops.linalg import dot_hp, marginal_core, marginal_nlp
from ..utils import metrics
from .meanfun import design_matrix
from .params import GPParams, _process_nugget
from .priors import GPPriors, dist_logp

__all__ = [
    "GPData",
    "FitArtifacts",
    "make_gp_data",
    "cat_lanes",
    "take_lanes",
    "gp_fit",
    "gp_nlp",
    "gp_predict",
    "gp_predict_tiled",
    "tiled_query_map",
    "GaussianProcess",
    "PredictResult",
]


class GPData(NamedTuple):
    """Training data and packed priors, lanes first.

    Mean-prior information is unrolled into arrays (zeros for weak priors):
    ``mean_mean`` = prior mean ``b``, ``mean_inv_cov`` = ``B^-1``,
    ``mean_logdet_cov`` = ``log det B``,
    ``n_coeff`` = the coefficient count in the 2-pi normalization.
    """

    inputs: torch.Tensor          # (L, n, D)
    targets: torch.Tensor         # (L, n)
    dm: torch.Tensor              # (L, n, M)
    prior_codes: torch.Tensor     # (L, P) int64
    prior_a: torch.Tensor         # (L, P)
    prior_b: torch.Tensor         # (L, P)
    fixed_nugget: torch.Tensor    # (L,); only used for nugget_type="fixed"
    mean_mean: torch.Tensor       # (L, M)
    mean_inv_cov: torch.Tensor    # (L, M, M)
    mean_logdet_cov: torch.Tensor  # (L,)
    n_coeff: torch.Tensor         # (L,)


class FitArtifacts(NamedTuple):
    """Everything the reference ``fit`` caches, lanes first."""

    raw: torch.Tensor          # (L, P) raw hyperparameters used for the fit
    Kinv: ChoFactor            # factor of K (+ nugget), (L, n, n); a
                               # PivotedChoFactor for nugget_type="pivot"
    Ainv: ChoFactor            # factor of A = H^T K^-1 H + B^-1, (L, M, M)
    mean: torch.Tensor         # (L, M) analytic mean coefficients
    Kinv_t_mean: torch.Tensor  # (L, n) K^-1 (y - H mean)
    Kinv_dm: torch.Tensor      # (L, n, M) K^-1 H; predict builds the R
                               # correction with a matmul instead of a solve
    nugget: torch.Tensor       # (L,) realized nugget
    logpost: torch.Tensor      # (L,) negative log posterior


def _tree_map(fn, *trees):
    """Apply ``fn`` leafwise over NamedTuples of tensors."""
    if isinstance(trees[0], tuple) and hasattr(trees[0], "_fields"):
        return type(trees[0])(*[_tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def cat_lanes(trees):
    """Concatenate ``GPData`` / ``FitArtifacts`` along the lanes axis."""
    return _tree_map(lambda *xs: torch.cat(xs), *trees)


def take_lanes(tree, index):
    """Index every leaf along the lanes axis (a slice keeps the axis)."""
    return _tree_map(lambda x: x[index], tree)


def make_gp_data(inputs, targets, dm, priors, nugget_value=0.0, dtype=None,
                 device=None):
    """One-lane ``GPData`` from host-side objects."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    dm = np.asarray(dm)
    n, M = dm.shape
    codes, a, b, _ = priors.packed()
    mp = priors.mean
    if mp.has_weak_priors:
        mean_mean = np.zeros(M)
        mean_inv_cov = np.zeros((M, M))
        mean_logdet = 0.0
        n_coeff = n - M
    else:
        mean_mean = mp.mean
        mean_inv_cov = np.reshape(mp.inv_cov(), (M, M))
        mean_logdet = mp.logdet_cov()
        n_coeff = n

    fields = dict(
        inputs=t(inputs),
        targets=t(targets),
        dm=t(dm),
        prior_codes=t(codes, torch.int64),
        prior_a=t(a),
        prior_b=t(b),
        fixed_nugget=t(0.0 if nugget_value is None else nugget_value),
        mean_mean=t(mean_mean),
        mean_inv_cov=t(mean_inv_cov),
        mean_logdet_cov=t(mean_logdet),
        n_coeff=t(n_coeff),
    )
    return GPData(**{k: v[None] for k, v in fields.items()})


def _prior_logp(data: GPData, raw, n_corr, nugget_type):
    """Packed-prior log density of raw vectors ``(L, P)``, per lane."""
    vals = [torch.exp(-0.5 * raw[:, :n_corr]), torch.exp(raw[:, n_corr : n_corr + 1])]
    if nugget_type == "fit":
        vals.append(torch.exp(raw[:, -1:]))
    vals = torch.cat(vals, dim=-1)
    return torch.sum(dist_logp(data.prior_codes, data.prior_a, data.prior_b, vals), dim=-1)


def _matvec(A, v):
    """``A @ v`` over lanes for a vector ``v`` ``(..., k)``."""
    return dot_hp(A, v[..., None])[..., 0]


def _factor_K(raw, data: GPData, kernel, nugget_type, **factor_kw):
    """Covariance build and nugget-aware factorization shared by
    :func:`gp_fit` and :func:`gp_nlp`: ``(n_corr, Kinv, nugget, core)``
    with ``core`` the stacked half-solve ``W = L^-1 [H | (y - m)]``
    (``ops/linalg.py``)."""
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = raw[:, :n_corr]
    sigma2 = torch.exp(raw[:, n_corr])

    if nugget_type == "fit":
        nugget = torch.exp(raw[:, -1])
    elif nugget_type == "fixed":
        nugget = data.fixed_nugget
    else:
        nugget = torch.zeros_like(sigma2)

    m = _matvec(data.dm, data.mean_mean)
    K = sigma2[:, None, None] * kernel.kernel_f(data.inputs, data.inputs, corr_raw)
    Kinv, nugget = cholesky_factor(K, nugget, nugget_type, **factor_kw)
    core = marginal_core(Kinv, data.dm, data.targets - m, data.mean_inv_cov)
    return n_corr, Kinv, nugget, core


def gp_nlp(raw, data: GPData, kernel, nugget_type, reuse_factor=True,
           sparse_ladder=False, progressive_ok=True):
    """Negative log posterior ``(L,)`` of raw hyperparameters ``(L, P)``:
    the MAP objective.  Differentiable by autograd in ``raw``; its
    gradient replaces the reference's hand-derived ``logpost_deriv``.

    The lean form: one lower half-solve, no upper sweeps, no prediction
    artifacts.  ``reuse_factor`` / ``sparse_ladder`` / ``progressive_ok``
    go to the adaptive jitter ladder (``ops/cholesky.py``).

    Recorded (``utils/metrics.py``) as the span ``gp.nlp``, the forward's
    enqueue, and the counter ``gp.nlp_lanes``, the lanes evaluated.
    """
    metrics.count("gp.nlp_lanes", raw.shape[0])
    with metrics.span("gp.nlp"):
        n_corr, Kinv, _, core = _factor_K(
            raw, data, kernel, nugget_type, reuse_factor=reuse_factor,
            sparse_ladder=sparse_ladder, progressive_ok=progressive_ok,
        )
        logpost = marginal_nlp(core, Kinv, data.mean_logdet_cov, data.n_coeff)
        return logpost - _prior_logp(data, raw, n_corr, nugget_type)


@torch.no_grad()
def gp_fit(raw, data: GPData, kernel, nugget_type, reuse_factor=True,
           sparse_ladder=False, progressive_ok=True):
    """Fit-time artifacts for raw hyperparameters ``raw`` ``(L, P)``.

    Covariance build, nugget-aware factorization, analytic mean solve and
    the negative log posterior including the prior term.
    """
    n_corr, Kinv, nugget, core = _factor_K(
        raw, data, kernel, nugget_type, reuse_factor=reuse_factor,
        sparse_ladder=sparse_ladder, progressive_ok=progressive_ok,
    )
    Ainv = core.Ainv

    # analytic mean: beta_hat = A^-1 (H^T K^-1 y + B^-1 b), which is
    # b + A^-1 H^T K^-1 (y - H b) since A b = H^T K^-1 H b + B^-1 b
    # (core.H_Kinv_t is taken at the residual y - H b)
    mean = data.mean_mean + Ainv.solve(core.H_Kinv_t)

    # the upper sweep completes the prediction artifacts;
    # Kinv_t_mean = K^-1 (y - H mean) = Kinv_t + (K^-1 H)(b - mean)
    full = Kinv.solve_from_half(core.W)
    Kinv_dm, Kinv_t = full[..., :-1], full[..., -1]
    Kinv_t_mean = Kinv_t + _matvec(Kinv_dm, data.mean_mean - mean)

    logpost = marginal_nlp(core, Kinv, data.mean_logdet_cov, data.n_coeff)
    logpost = logpost - _prior_logp(data, raw, n_corr, nugget_type)

    return FitArtifacts(
        raw=raw,
        Kinv=Kinv,
        Ainv=Ainv,
        mean=mean,
        Kinv_t_mean=Kinv_t_mean,
        Kinv_dm=Kinv_dm,
        nugget=nugget,
        logpost=logpost,
    )


def _gp_predict_impl(
    artifacts: FitArtifacts,
    data: GPData,
    testing,
    dmtest,
    kernel,
    nugget_type,
    unc=True,
    include_nugget=True,
    full_cov=False,
):
    """Predictive mean and (co)variance for every lane.

    Where :func:`_predict_route` says ``"fused"``, one call of
    ``ops/predict_fused.py`` (the fused kernel on the card, its plain
    version on the CPU) computes the formulas below without a
    cross-covariance in device memory; otherwise K1 builds ``Ktest`` and
    the solves follow.

    :param testing: ``(m, D)`` query points, shared by the lanes.
    :param dmtest: ``(m, M)`` design matrix of the query points.
    :returns: ``(mu, var)``: ``mu`` ``(L, m)``; ``var`` ``None`` if not
        ``unc``, ``(L, m)`` variances, or ``(L, m, m)`` if ``full_cov``.
    """
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = artifacts.raw[:, :n_corr]
    sigma2 = torch.exp(artifacts.raw[:, n_corr])
    with_nugget = include_nugget and nugget_type != "pivot"

    if _predict_route(data, kernel, full_cov, nugget_type) == "fused":
        var_shift = sigma2 + artifacts.nugget if with_nugget else sigma2
        return pf.predict_fused(
            *kernel.lane_inputs(data.inputs, testing, corr_raw, sigma2),
            artifacts.Kinv.L.contiguous(), artifacts.Kinv_t_mean.contiguous(),
            artifacts.Kinv_dm.contiguous(), dmtest.contiguous(), artifacts.mean.contiguous(),
            artifacts.Ainv.L.contiguous(), var_shift.contiguous(), unc=unc, base=kernel.base,
        )

    mtest = _matvec(dmtest, artifacts.mean)
    # the fused kernel-matrix build (CUDA on the card), sigma2 included
    Ktest = kernel.kernel_f_predict(data.inputs, testing, corr_raw, sigma2)

    mu = mtest + _matvec(Ktest.transpose(-1, -2), artifacts.Kinv_t_mean)

    if not unc:
        return mu, None

    # R = H*^T - H^T K^-1 K* via the stored K^-1 H (K is symmetric); the
    # quadratic forms use half-solves, one lower sweep each
    R = dmtest.T - dot_hp(artifacts.Kinv_dm.transpose(-1, -2), Ktest)  # (L, M, m)
    Linv_Ktest = artifacts.Kinv.solve_L(Ktest)
    LAinv_R = artifacts.Ainv.solve_L(R)

    if full_cov:
        sigma_2 = kernel.kernel_f_predict(testing, testing, corr_raw, sigma2)
        if with_nugget:
            eye = torch.eye(testing.shape[0], dtype=sigma_2.dtype, device=sigma_2.device)
            sigma_2 = sigma_2 + eye * artifacts.nugget[:, None, None]
        var = (
            sigma_2
            - dot_hp(Linv_Ktest.transpose(-1, -2), Linv_Ktest)
            + dot_hp(LAinv_R.transpose(-1, -2), LAinv_R)
        )
    else:
        sigma_2 = sigma2 + artifacts.nugget if with_nugget else sigma2
        var = torch.clamp_min(
            sigma_2[:, None]
            - torch.sum(Linv_Ktest**2, dim=-2)
            + torch.sum(LAinv_R**2, dim=-2),
            0.0,
        )
    return mu, var


gp_predict = torch.no_grad()(_gp_predict_impl)
gp_predict.__name__ = "gp_predict"


@torch.no_grad()
def gp_predict_tiled(
    artifacts: FitArtifacts,
    data: GPData,
    testing,
    dmtest,
    kernel,
    nugget_type,
    unc=True,
    include_nugget=True,
    tile=32768,
):
    """Prediction over fixed-size query tiles.

    On the unfused route the per-tile working set -- the ``(L, n, tile)``
    cross-covariance, its half-solve and the ``(L, M, tile)`` correction --
    is all that exists on the device at once besides the outputs; on the
    fused route a tile holds only its queries and outputs.  Tiles are
    enqueued without a host sync.  Full covariance is not supported here.

    :returns: ``(mu, var)`` with ``var`` ``None`` when ``unc`` is False.
    """
    def one(t, dm):
        return _gp_predict_impl(
            artifacts, data, t, dm, kernel, nugget_type,
            unc=unc, include_nugget=include_nugget, full_cov=False,
        )

    outs, m = tiled_query_map(testing, dmtest, tile, one)
    mu = torch.cat([o[0] for o in outs], dim=-1)[..., :m]
    if not unc:
        return mu, None
    return mu, torch.cat([o[1] for o in outs], dim=-1)[..., :m]


def tiled_query_map(testing, dmtest, tile, body):
    """Pad the query axis to a ``tile`` multiple by repeating the final row
    (padded queries compute finite values the caller slices off), cut it
    into tiles and apply ``body(testing_tile, dmtest_tile)`` to each.

    :returns: ``(list_of_outputs, m)`` with ``m`` the true query count.
    """
    m = testing.shape[0]
    n_tiles = -(-m // tile)
    pad = n_tiles * tile - m
    if pad:
        testing = torch.cat([testing, testing[-1:].expand(pad, -1)], dim=0)
        dmtest = torch.cat([dmtest, dmtest[-1:].expand(pad, -1)], dim=0)
    t3 = testing.reshape(n_tiles, tile, testing.shape[1])
    dm3 = dmtest.reshape(n_tiles, tile, dmtest.shape[1])
    return [body(t3[i], dm3[i]) for i in range(n_tiles)], m


def _predict_route(data, kernel, full_cov=False, nugget_type=None):
    """``ops/predict_fused.py``'s route for these lanes: ``"fused"`` or
    ``"unfused"``.  ``nugget_type="pivot"`` is always unfused: the fused
    kernel solves with an unpermuted factor and no rank mask."""
    if nugget_type == "pivot":
        return "unfused"
    return pf.route(data.inputs.device, data.inputs.shape[-2], data.dm.shape[-1],
                    kernel.form, full_cov, data.inputs.dtype)


def _query_tile(n_testing, max_batch_size, data, kernel, nugget_type=None):
    """:func:`_predict_tile_size` for predicting ``data``'s lanes without
    full covariance: the fused rule on the card's fused route."""
    L, n, D = data.inputs.shape
    fused = (data.inputs.device.type == "cuda"
             and _predict_route(data, kernel, nugget_type=nugget_type) == "fused")
    return _predict_tile_size(n_testing, max_batch_size, n_train=n, n_lanes=L, fused=fused,
                              n_dim=D, n_mean=data.dm.shape[-1])


def _predict_tile_size(n_testing, max_batch_size, n_train=None, n_lanes=1, fused=False,
                       n_dim=0, n_mean=0):
    """Query-tile size for chunked prediction, 0 for "do not chunk".

    ``None`` -> automatic: unchunked below the auto tile, tiled above.  The
    auto tile keeps ~4 ``(n_lanes, n_train, tile)`` buffers under
    ``_PREDICT_TILE_BYTES``.  With ``fused`` (the fused kernel on the card)
    no such buffer exists: what lives on the device per query is its
    ``n_dim`` inputs, its ``n_mean`` design-matrix terms and a mean and a
    variance per lane, counted at 8 bytes each, and the tile keeps those
    under ``_PREDICT_TILE_BYTES``, split evenly so that the padded last
    tile computes little that is thrown away.  An explicit value is rounded
    up to a multiple of 256.
    """
    if max_batch_size is None:
        if fused:
            per_query = 8 * (2 * max(1, n_lanes) + n_dim + n_mean)
            cap = max(256, _PREDICT_TILE_BYTES // per_query // 256 * 256)
            if n_testing <= cap:
                return 0
            n_tiles = -(-n_testing // cap)
            return -(-n_testing // (256 * n_tiles)) * 256
        tile = _AUTO_PREDICT_TILE
        if n_train:
            budget = _PREDICT_TILE_BYTES // (16 * int(n_train) * max(1, n_lanes))
            tile = min(tile, max(256, budget // 256 * 256))
        return tile if n_testing > tile else 0
    tile = int(max_batch_size)
    assert tile > 0, "max_batch_size must be positive"
    tile = -(-tile // 256) * 256
    return tile if n_testing > tile else 0


_AUTO_PREDICT_TILE = 32768
_PREDICT_TILE_BYTES = 1 << 30


def _host_summary(arts):
    """``[nugget, logpost, mean...]`` per lane, float64 numpy, in ONE
    device-to-host transfer for all lanes."""
    summary = torch.cat([arts.nugget[:, None], arts.logpost[:, None], arts.mean], dim=-1)
    return summary.to("cpu", torch.float64).numpy()


# ---------------------------------------------------------------------------
# Reference-parity class
# ---------------------------------------------------------------------------

class PredictResult(dict):
    """Prediction results: dict/tuple/attribute hybrid."""

    _fields = ("mean", "unc", "deriv")

    def __init__(self, mean=None, unc=None, deriv=None):
        super().__init__(mean=mean, unc=unc, deriv=deriv)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, int):
            return dict.__getitem__(self, self._fields[key])
        return dict.__getitem__(self, key)

    def __iter__(self):
        return iter(self[f] for f in self._fields)

    def __len__(self):
        return 3


class GaussianProcessBase:
    pass


class GaussianProcess(GaussianProcessBase):
    """Single-output GP emulator with the reference API surface.

    ``device`` (default CPU) and ``dtype`` (default: float64 on CPU,
    float32 on CUDA) say where the fit artifacts live and in which type;
    results come back as float64 numpy arrays.

    Example::

        >>> import numpy as np
        >>> from mogp_tpu_torch import GaussianProcess
        >>> x = np.array([[1., 2., 3.], [4., 5., 6.]])
        >>> gp = GaussianProcess(x, np.array([4., 6.]), device="cpu")
        >>> gp.fit(np.zeros(4))
        >>> mu, var, _ = gp.predict(np.array([[2., 3., 4.]]))
    """

    def __init__(
        self,
        inputs,
        targets,
        mean=None,
        kernel="SquaredExponential",
        priors=None,
        nugget="adaptive",
        inputdict={},
        use_patsy=True,
        standardize=False,
        device=None,
        dtype=None,
    ):
        inputs = self._process_inputs(inputs)
        targets = np.asarray(targets, dtype=np.float64)
        assert targets.ndim == 1
        assert targets.shape[0] == inputs.shape[0]

        self._device = resolve_device(device)
        self._dtype = dtype or default_dtype(self._device)

        # optional target standardization: the GP is fit on (y - mean)/std
        # and predictions are mapped back
        self._standardize = bool(standardize)
        if self._standardize:
            self._t_mean = float(np.mean(targets))
            self._t_std = float(np.std(targets)) or 1.0
            targets_model = (targets - self._t_mean) / self._t_std
        else:
            self._t_mean, self._t_std = 0.0, 1.0
            targets_model = targets

        self.kernel = get_kernel(kernel)
        self._inputs = inputs
        self._targets = targets
        self._targets_model = targets_model

        if inputdict:
            warnings.warn(
                "The inputdict interface for mean functions has been deprecated.",
                DeprecationWarning,
            )
        if not use_patsy:
            warnings.warn(
                "formulae are parsed natively; the use_patsy option is ignored.",
                DeprecationWarning,
            )

        self._mean = mean
        # categorical C(...) level bindings, captured from the training
        # inputs and reused for every later design matrix
        self._mean_state = {}
        self._dm = design_matrix(mean, self._inputs, state=self._mean_state)

        nugget_value, self._nugget_type = _process_nugget(nugget)

        self._set_priors(priors)
        self._prior_codes = tuple(self._priors.packed()[0].tolist())

        self._theta = GPParams(
            n_mean=self.n_mean, n_corr=self.n_corr, nugget=nugget
        )
        self._nugget_value = nugget_value

        self._data = make_gp_data(
            self._inputs,
            self._targets_model,
            self._dm,
            self._priors,
            nugget_value=nugget_value if nugget_value is not None else 0.0,
            dtype=self._dtype,
            device=self._device,
        )
        self._artifacts = None

    # -- basic properties ---------------------------------------------------

    @property
    def inputs(self):
        return self._inputs

    @property
    def targets(self):
        return self._targets

    @property
    def n(self):
        return self._inputs.shape[0]

    @property
    def D(self):
        return self._inputs.shape[1]

    @property
    def n_mean(self):
        return self._dm.shape[1]

    @property
    def n_corr(self):
        return self.kernel.get_n_params(self._inputs)

    @property
    def n_params(self):
        """Number of fitting parameters."""
        return self.n_corr + 1 + int(self._nugget_type == "fit")

    @property
    def nugget_type(self):
        return self._nugget_type

    @property
    def nugget(self):
        return self._theta.nugget

    @property
    def theta(self):
        """Current hyperparameters as ``GPParams``."""
        return self._theta

    @theta.setter
    def theta(self, newtheta):
        if newtheta is None:
            self._theta = GPParams(
                n_mean=self.n_mean,
                n_corr=self.n_corr,
                nugget=(
                    self._nugget_value
                    if self._nugget_type == "fixed"
                    else self._nugget_type
                ),
            )
            self._artifacts = None
        else:
            self.fit(newtheta)

    @property
    def priors(self):
        return self._priors

    def _set_priors(self, priors):
        """Resolve the priors argument."""
        if priors is None:
            self._priors = GPPriors.default_priors(
                self._inputs, self.n_corr, nugget_type=self._nugget_type
            )
        elif isinstance(priors, GPPriors):
            self._priors = priors
        elif isinstance(priors, dict):
            self._priors = GPPriors(**priors)
        else:
            raise ValueError(
                "priors must be a GPPriors object, dict of kwargs, or None"
            )
        if self._priors.n_mean > 0:
            assert self._priors.n_mean == self.n_mean
        assert self._priors.n_corr == self.n_corr, (
            "bad number of correlation lengths in GPPriors object"
        )
        assert self._priors.nugget_type == self._nugget_type, (
            "nugget type of GPPriors object does not match"
        )

    # -- design / covariance helpers ---------------------------------------

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self._dtype, device=self._device)

    def get_design_matrix(self, inputs):
        """Design matrix for a set of inputs."""
        inputs = self._process_inputs(inputs)
        assert inputs.shape[1] == self.D, "bad shape for inputs"
        return design_matrix(self._mean, inputs, state=self._mean_state)

    def get_cov_matrix(self, other_inputs):
        """Covariance of training inputs vs ``other_inputs``."""
        other = self._process_inputs(other_inputs)
        K = self.kernel.kernel_f(
            self._tensor(self._inputs), self._tensor(other),
            self._tensor(self._theta.corr_raw),
        )
        return self._theta.cov * K.to("cpu", torch.float64).numpy()

    def get_K_matrix(self):
        """Current training covariance, without nugget."""
        return self.get_cov_matrix(self._inputs)

    def _process_inputs(self, inputs):
        inputs = np.asarray(inputs, dtype=np.float64)
        if inputs.ndim == 1:
            if not hasattr(self, "_inputs") or self.D == 1:
                inputs = np.reshape(inputs, (-1, 1))
            else:
                inputs = np.reshape(inputs, (1, -1))
        assert inputs.ndim == 2, "bad shape for input"
        if hasattr(self, "_inputs"):
            assert inputs.shape[1] == self.D, (
                "second dimension of other inputs must match the number of "
                "input parameters"
            )
        return inputs

    # -- fitting ------------------------------------------------------------

    def _coerce_theta(self, theta):
        if isinstance(theta, GPParams):
            assert self._theta.same_shape(theta), "bad shape for hyperparameters"
            if theta.mean is not None and theta.n_mean > 0:
                warnings.warn(
                    "Setting mean parameters with a GPParams object is not "
                    "supported. The provided values will be overwritten with "
                    "the analytical mean solution."
                )
            raw = theta.get_data()
        else:
            raw = np.asarray(theta, dtype=np.float64)
            assert self._theta.same_shape(raw), "bad shape for hyperparameters"
        return raw

    def fit(self, theta):
        """Fit the emulator at hyperparameters ``theta``."""
        raw = self._coerce_theta(theta)
        arts = gp_fit(self._tensor(raw)[None], self._data, self.kernel, self._nugget_type)
        self._set_fit_artifacts(raw, arts, _host_summary(arts)[0])

    def _set_fit_artifacts(self, raw, arts, summary):
        """Install one-lane artifacts with their host summary row
        ``[nugget, logpost, mean...]`` (see ``_host_summary``)."""
        self._artifacts = arts
        self._theta.set_data(np.asarray(raw, dtype=np.float64))
        self._theta.mean = summary[2:]
        if self._nugget_type == "adaptive":
            self._theta.nugget = float(summary[0])
        self.current_logpost = float(summary[1])

    @property
    def Kinv(self):
        return None if self._artifacts is None else take_lanes(self._artifacts.Kinv, 0)

    @property
    def Ainv(self):
        return None if self._artifacts is None else take_lanes(self._artifacts.Ainv, 0)

    @property
    def Kinv_t_mean(self):
        return None if self._artifacts is None else self._artifacts.Kinv_t_mean[0]

    def logposterior(self, theta):
        """Negative log posterior at ``theta``."""
        if self._refit(theta):
            self.fit(theta)
        return self.current_logpost

    def _nlp_of(self, reuse_factor=True):
        """``gp_nlp`` of one raw vector ``(P,)`` on this emulator's data."""
        return lambda r: gp_nlp(r[None], self._data, self.kernel, self._nugget_type,
                                reuse_factor=reuse_factor)[0]

    def logpost_deriv(self, theta):
        """Gradient of the negative log posterior, by autograd."""
        theta = np.asarray(theta, dtype=np.float64)
        if self._refit(theta):
            self.fit(theta)
        with torch.enable_grad():
            raw = self._tensor(theta).requires_grad_(True)
            (g,) = torch.autograd.grad(self._nlp_of()(raw), raw)
        return g.to("cpu", torch.float64).numpy()

    def logpost_hessian(self, theta):
        """Hessian of the negative log posterior, by autograd twice.  The
        factor is recomputed differentiably (``reuse_factor=False``), as
        the JAX package does for its Hessian."""
        theta = np.asarray(theta, dtype=np.float64)
        if self._refit(theta):
            self.fit(theta)
        h = torch.autograd.functional.hessian(
            self._nlp_of(reuse_factor=False), self._tensor(theta))
        return h.to("cpu", torch.float64).numpy()

    def _refit(self, newtheta):
        """Refit check."""
        current = self._theta.get_data()
        if current is None or self._artifacts is None:
            return True
        newtheta = np.asarray(newtheta)
        return not np.allclose(newtheta, current, rtol=1.0e-10, atol=1.0e-15)

    # -- prediction ---------------------------------------------------------

    def predict(
        self, testing, unc=True, deriv=False, include_nugget=True,
        full_cov=False, max_batch_size=None,
    ):
        """Predict mean/variance at query points.

        ``max_batch_size`` bounds device memory for very large query sets:
        queries are processed in fixed-size tiles (``gp_predict_tiled``).
        Default ``None`` chunks automatically above ``_AUTO_PREDICT_TILE``
        points; ignored with ``full_cov``.
        """
        if self._theta.get_data() is None or self._artifacts is None:
            raise ValueError(
                "hyperparameters have not been fit for this Gaussian Process"
            )
        testing = self._process_inputs(testing)
        dmtest = self.get_design_matrix(testing)

        tile = 0 if full_cov else _query_tile(
            testing.shape[0], max_batch_size, self._data, self.kernel, self._nugget_type
        )
        args = (
            self._artifacts, self._data, self._tensor(testing),
            self._tensor(dmtest), self.kernel, self._nugget_type,
        )
        if tile:
            mu, var = gp_predict_tiled(
                *args, unc=bool(unc), include_nugget=bool(include_nugget), tile=tile,
            )
        else:
            mu, var = gp_predict(
                *args, unc=bool(unc), include_nugget=bool(include_nugget),
                full_cov=bool(full_cov),
            )

        if deriv:
            warnings.warn(
                "Prediction derivatives have been deprecated and are no "
                "longer supported",
                DeprecationWarning,
            )
        mu = mu[0].to("cpu", torch.float64).numpy()
        var = None if var is None else var[0].to("cpu", torch.float64).numpy()
        if self._standardize:
            mu = mu * self._t_std + self._t_mean
            if var is not None:
                var = var * self._t_std**2
        return PredictResult(mean=mu, unc=var, deriv=None)

    def __call__(self, testing):
        return self.predict(testing, unc=False, deriv=False)[0]

    # -- serialization ------------------------------------------------------

    def __getstate__(self):
        """Pickle by re-initialization: device artifacts are dropped and
        rebuilt from the hyperparameters on unpickling."""
        return {
            "inputs": np.asarray(self._inputs),
            "targets": np.asarray(self._targets),
            "standardize": self._standardize,
            "mean": self._mean,
            "kernel": type(self.kernel).__name__,
            "priors": self._priors,
            "nugget": (
                self._nugget_value
                if self._nugget_type == "fixed"
                else self._nugget_type
            ),
            "theta": (
                None
                if self._theta.get_data() is None
                else np.asarray(self._theta.get_data())
            ),
            "device": str(self._device),
            "dtype": str(self._dtype).replace("torch.", ""),
        }

    def __setstate__(self, state):
        self.__init__(
            state["inputs"],
            state["targets"],
            mean=state["mean"],
            kernel=state["kernel"],
            priors=state["priors"],
            nugget=state["nugget"],
            standardize=state.get("standardize", False),
            device=state["device"],
            dtype=getattr(torch, state["dtype"]),
        )
        if state["theta"] is not None:
            self.fit(state["theta"])

    def __str__(self):
        return (
            "Gaussian Process with "
            + str(self.n)
            + " training examples and "
            + str(self.D)
            + " input variables"
        )
