"""Prior distributions over GP hyperparameters.

Port of ``mogp_tpu/models/priors.py``:

* Distribution objects (``NormalPrior``, ``LogNormalPrior``, ``GammaPrior``,
  ``InvGammaPrior``, ``WeakPrior``) keep the reference API surface
  (``logp`` / ``dlogpdx`` / ``dlogpdtheta`` / ``sample``); log densities
  are torch expressions and derivatives come from autograd.
* Every distribution lowers to a coded form ``(code, a, b)``, so a prior
  set packs into flat arrays and :func:`dist_logp` evaluates it
  elementwise over lanes and parameter slots at once.
* Data-driven default priors (``GPPriors.default_priors``) do their scipy
  root solves on the host at model construction.

Restart starts of the MAP fit come from the host samplers (``sample`` /
``sample_n``, numpy's global RNG), so a seeded fit draws the same starts
as ``mogp_tpu``.  :func:`dist_sample_raw` / ``GPPriors.sample_raw`` draw
on the device from a given ``torch.Generator``: the starts of NUTS chains
that have no ``theta0`` (``models/inference.py``).
"""

import math

import numpy as np
import scipy.stats
import torch
from scipy.optimize import root

from ..ops.transforms import CorrTransform, CovTransform

__all__ = [
    "WeakPrior",
    "PriorDist",
    "NormalPrior",
    "LogNormalPrior",
    "GammaPrior",
    "InvGammaPrior",
    "MeanPriors",
    "GPPriors",
    "dist_logp",
    "dist_sample_raw",
    "max_spacing",
    "min_spacing",
]

# distribution codes for the packed representation
DIST_WEAK = 0
DIST_NORMAL = 1
DIST_LOGNORMAL = 2
DIST_GAMMA = 3
DIST_INVGAMMA = 4

# transform codes
TRANSFORM_CORR = 0
TRANSFORM_COV = 1

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Coded (packed) log-density -- the batchable path
# ---------------------------------------------------------------------------

def _logp_normal(x, a, b):
    return -0.5 * ((x - a) / b) ** 2 - torch.log(b) - 0.5 * _LOG_2PI


def _logp_lognormal(x, a, b):
    # a = shape, b = scale
    return -0.5 * (torch.log(x / b) / a) ** 2 - 0.5 * _LOG_2PI - torch.log(x) - torch.log(a)


def _logp_gamma(x, a, b):
    # a = shape, b = scale
    return -a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x) - x / b


def _logp_invgamma(x, a, b):
    # a = shape, b = scale
    return a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - b / x


_CODED_BRANCHES = (
    (DIST_NORMAL, _logp_normal),
    (DIST_LOGNORMAL, _logp_lognormal),
    (DIST_GAMMA, _logp_gamma),
    (DIST_INVGAMMA, _logp_invgamma),
)


def dist_logp(code, a, b, x):
    """Log density of distribution ``code`` with parameters ``(a, b)`` at
    the transformed value ``x``, elementwise over tensors of one shape.

    Every branch is evaluated on every slot and ``torch.where`` picks the
    coded one (weak priors give 0).  Where a slot has another code, its
    branch sees ``a = b = x = 1`` instead of the slot's values, which lie in
    every branch's domain: a Normal prior's mean never reaches ``lgamma``
    or ``log``, so no branch gives ``-inf`` or NaN, and the gradient
    through ``torch.where`` (zero times the unpicked branch) stays finite.
    """
    out = torch.zeros_like(x)
    for c, fn in _CODED_BRANCHES:
        pick = code == c
        out = torch.where(
            pick, fn(torch.where(pick, x, 1.0), torch.where(pick, a, 1.0),
                     torch.where(pick, b, 1.0)), out)
    return out


def dist_sample_raw(code, a, b, transform_code, generator):
    """One draw per slot of coded distributions, in raw parameter space
    (``mogp_tpu/models/priors.py:104-130``): tensors of one shape on the
    generator's device, floating ``a`` / ``b``.

    Weak priors draw the raw value uniformly on [-2.5, 2.5]
    (``Priors.py:668``); the others draw the transformed value (Normal:
    ``a + b z``; LogNormal: ``b exp(a z)``; Gamma: shape ``a``, scale
    ``b``; InvGamma: ``b / Gamma(a, 1)``) and invert the slot's transform.
    Every family is drawn for every slot and ``torch.where`` picks the
    coded one, as ``dist_logp`` does.
    """
    z = torch.randn(a.shape, generator=generator, dtype=a.dtype, device=a.device)
    g = torch._standard_gamma(torch.clamp_min(a, 1e-12), generator=generator)
    u = torch.rand(a.shape, generator=generator, dtype=a.dtype, device=a.device)
    x = torch.ones_like(a)
    for c, value in (
        (DIST_NORMAL, a + b * z),
        (DIST_LOGNORMAL, torch.exp(a * z) * b),
        (DIST_GAMMA, g * b),
        (DIST_INVGAMMA, b / torch.clamp_min(g, 1e-30)),
    ):
        x = torch.where(code == c, value, x)
    x = torch.clamp_min(x, 1e-300)
    raw = torch.where(transform_code == TRANSFORM_CORR, CorrTransform.inv_transform(x),
                      CovTransform.inv_transform(x))
    return torch.where(code == DIST_WEAK, 5.0 * (u - 0.5), raw)


def _scalar(v):
    return torch.as_tensor(v, dtype=torch.float64)


# ---------------------------------------------------------------------------
# Distribution objects (API parity with the reference Priors.py)
# ---------------------------------------------------------------------------

class WeakPrior:
    """Flat (improper) prior."""

    code = DIST_WEAK

    @property
    def packed_params(self):
        return (1.0, 1.0)

    def logp(self, x):
        return torch.zeros((), dtype=torch.float64)

    def dlogpdx(self, x):
        return 0.0

    def d2logpdx2(self, x):
        return 0.0

    def _raw_derivs(self, x, transform, order):
        raw = _scalar(transform.inv_transform(_scalar(x))).requires_grad_(True)
        val = self.logp(transform.transform(raw))
        if not val.requires_grad:
            return 0.0
        (g,) = torch.autograd.grad(val, raw, create_graph=order > 1)
        if order == 1:
            return float(g)
        if not g.requires_grad:
            return 0.0
        (h,) = torch.autograd.grad(g, raw)
        return float(h)

    def dlogpdtheta(self, x, transform):
        """Derivative of the log density with respect to the raw parameter."""
        return self._raw_derivs(x, transform, 1)

    def d2logpdtheta2(self, x, transform):
        return self._raw_derivs(x, transform, 2)

    def sample(self, transform=None):
        return float(5.0 * (np.random.rand() - 0.5))

    def sample_n(self, transform=None, n=1):
        """Vectorized :meth:`sample`: ``n`` draws in one RNG call."""
        return 5.0 * (np.random.rand(n) - 0.5)


class PriorDist(WeakPrior):
    """Base for proper prior distributions."""

    @classmethod
    def default_prior(cls, min_val, max_val):
        """Fit distribution parameters so 99% of the mass lies in
        ``[min_val, max_val]``."""
        dist_map = {
            InvGammaPrior: scipy.stats.invgamma,
            GammaPrior: scipy.stats.gamma,
            LogNormalPrior: scipy.stats.lognorm,
        }
        if cls not in dist_map:
            raise ValueError(
                "Default prior must be invgamma, gamma, or lognormal"
            )
        dist_obj = dist_map[cls]

        assert min_val > 0.0, "min_val must be positive"
        assert max_val > 0.0, "max_val must be positive"
        assert min_val < max_val, "min_val must be less than max_val"

        def f(x):
            cdf = dist_obj(np.exp(x[0]), scale=np.exp(x[1])).cdf
            return np.array([cdf(min_val) - 0.005, cdf(max_val) - 0.995])

        result = root(f, np.zeros(2))
        if not result["success"]:
            print("Prior solver failed to converge")
            return WeakPrior()
        return cls(np.exp(result["x"][0]), np.exp(result["x"][1]))

    @classmethod
    def default_prior_corr(cls, inputs):
        """Default prior from min/max input spacing."""
        min_val = min_spacing(inputs)
        max_val = max_spacing(inputs)
        if min_val == 0.0 or max_val == 0.0:
            print("Too few unique inputs; defaulting to flat priors")
            return WeakPrior()
        return cls.default_prior(min_val, max_val)

    def sample_x(self):
        raise NotImplementedError("PriorDist does not implement a sampler")

    def sample(self, transform):
        return float(np.asarray(transform.inv_transform(self.sample_x())))

    def sample_x_n(self, n):
        """Vectorized :meth:`sample_x`; subclasses draw ``rvs(size=n)``."""
        return np.array([self.sample_x() for _ in range(n)])

    def sample_n(self, transform, n=1):
        """``n`` raw-space samples in one vectorized draw."""
        return np.asarray(transform.inv_transform(self.sample_x_n(n)))

    def _x_derivs(self, x, order):
        x = _scalar(x).requires_grad_(True)
        (g,) = torch.autograd.grad(self.logp(x), x, create_graph=order > 1)
        if order == 1:
            return float(g)
        (h,) = torch.autograd.grad(g, x)
        return float(h)

    def dlogpdx(self, x):
        return self._x_derivs(x, 1)

    def d2logpdx2(self, x):
        return self._x_derivs(x, 2)

    def _logp_coded(self, fn, x):
        a, b = self.packed_params
        return fn(torch.as_tensor(x, dtype=torch.float64), _scalar(a), _scalar(b))


class NormalPrior(PriorDist):
    """Normal prior on the transformed value."""

    code = DIST_NORMAL

    def __init__(self, mean, std):
        assert std > 0.0, "std parameter must be positive"
        self.mean = float(mean)
        self.std = float(std)

    @property
    def packed_params(self):
        return (self.mean, self.std)

    def logp(self, x):
        return self._logp_coded(_logp_normal, x)

    def sample_x(self):
        return float(scipy.stats.norm.rvs(size=1, loc=self.mean, scale=self.std)[0])

    def sample_x_n(self, n):
        return scipy.stats.norm.rvs(size=n, loc=self.mean, scale=self.std)


class LogNormalPrior(PriorDist):
    """Lognormal prior, params (shape, scale)."""

    code = DIST_LOGNORMAL

    def __init__(self, shape, scale):
        assert shape > 0.0, "shape must be greater than zero"
        assert scale > 0.0, "scale must be greater than zero"
        self.shape = float(shape)
        self.scale = float(scale)

    @property
    def packed_params(self):
        return (self.shape, self.scale)

    def logp(self, x):
        return self._logp_coded(_logp_lognormal, x)

    def sample_x(self):
        return float(
            scipy.stats.lognorm.rvs(size=1, s=self.shape, scale=self.scale)[0]
        )

    def sample_x_n(self, n):
        return scipy.stats.lognorm.rvs(size=n, s=self.shape, scale=self.scale)


class GammaPrior(PriorDist):
    """Gamma prior, params (shape, scale)."""

    code = DIST_GAMMA

    def __init__(self, shape, scale):
        assert shape > 0.0, "shape parameter must be positive"
        assert scale > 0.0, "scale parameter must be positive"
        self.shape = float(shape)
        self.scale = float(scale)

    @property
    def packed_params(self):
        return (self.shape, self.scale)

    def logp(self, x):
        return self._logp_coded(_logp_gamma, x)

    def sample_x(self):
        return float(scipy.stats.gamma.rvs(size=1, a=self.shape, scale=self.scale)[0])

    def sample_x_n(self, n):
        return scipy.stats.gamma.rvs(size=n, a=self.shape, scale=self.scale)


class InvGammaPrior(PriorDist):
    """Inverse-gamma prior, params (shape, scale)."""

    code = DIST_INVGAMMA

    def __init__(self, shape, scale):
        assert shape > 0.0, "shape parameter must be positive"
        assert scale > 0.0, "scale parameter must be positive"
        self.shape = float(shape)
        self.scale = float(scale)

    @property
    def packed_params(self):
        return (self.shape, self.scale)

    @classmethod
    def default_prior_mode(cls, min_val, max_val):
        """Mode-anchored default: mode at the geometric mean of
        (min_val, max_val), 99.5% of mass below max_val."""
        assert min_val > 0.0
        assert max_val > 0.0
        assert min_val < max_val, "min_val must be less than max_val"

        mode = np.sqrt(min_val * max_val)

        def f(x):
            a = np.exp(x)
            return (
                scipy.stats.invgamma(a, scale=(1.0 + a) * mode).cdf(max_val) - 0.995
            )

        result = root(f, 0.0)
        if not result["success"]:
            print("Prior solver failed to converge")
            return WeakPrior()
        a = float(np.exp(result["x"][0]))
        return cls(a, scale=(1.0 + a) * mode)

    @classmethod
    def default_prior_corr_mode(cls, inputs):
        """Mode-anchored default from input spacing."""
        min_val = min_spacing(inputs)
        max_val = max_spacing(inputs)
        if min_val == 0.0 or max_val == 0.0:
            print("Too few unique inputs; defaulting to flat priors")
            return WeakPrior()
        return cls.default_prior_mode(min_val, max_val)

    @classmethod
    def default_prior_nugget(cls, min_val=1.0e-8, max_val=1.0e-6):
        """Small-nugget default."""
        return cls.default_prior_mode(min_val, max_val)

    def logp(self, x):
        return self._logp_coded(_logp_invgamma, x)

    def sample_x(self):
        return float(
            scipy.stats.invgamma.rvs(size=1, a=self.shape, scale=self.scale)[0]
        )

    def sample_x_n(self, n):
        return scipy.stats.invgamma.rvs(size=n, a=self.shape, scale=self.scale)


# ---------------------------------------------------------------------------
# Mean priors
# ---------------------------------------------------------------------------

class MeanPriors:
    """Multivariate-normal prior on mean coefficients (host numpy).

    ``mean is None`` indicates weak prior information; all methods then
    return zeros so the marginalized-mean math needs no conditionals.
    """

    def __init__(self, mean=None, cov=None):
        if mean is None:
            self.mean = None
            if cov is not None:
                import warnings

                warnings.warn(
                    "Both mean and cov need to be set to form a valid nontrivial "
                    "MeanPriors object. mean is not provided, so ignoring the "
                    "provided cov."
                )
            self.cov = None
            return
        self.mean = np.reshape(np.asarray(mean, dtype=np.float64), (-1,))
        if cov is None:
            raise ValueError(
                "Both mean and cov need to be set to form a valid MeanPriors object"
            )
        self.cov = np.asarray(cov, dtype=np.float64)
        if self.cov.ndim == 0:
            assert self.cov > 0.0, "covariance term must be greater than zero"
        elif self.cov.ndim == 1:
            assert len(self.cov) == len(self.mean), (
                "mean and variances must have the same length in MeanPriors"
            )
            assert np.all(self.cov > 0.0), "all variances must be greater than zero"
        elif self.cov.ndim == 2:
            assert self.cov.shape == (len(self.mean), len(self.mean)), (
                "mean and covariances must have the same shape in MeanPriors"
            )
            assert np.all(np.diag(self.cov) > 0.0)
        else:
            raise ValueError("Bad shape for the covariance in MeanPriors")

    @property
    def n_params(self):
        return 0 if self.mean is None else len(self.mean)

    @property
    def has_weak_priors(self):
        return self.mean is None

    def dm_dot_b(self, dm):
        """``H b`` or zeros under weak priors."""
        dm = np.asarray(dm)
        if self.mean is None:
            return np.zeros(dm.shape[0], dtype=dm.dtype)
        return dm @ self.mean

    def inv_cov(self):
        """``B^-1`` or scalar zero."""
        if self.cov is None:
            return 0.0
        if self.cov.ndim < 2:
            return np.diag(np.broadcast_to(1.0 / self.cov, (len(self.mean),)))
        return np.linalg.inv(self.cov)

    def inv_cov_b(self):
        """``B^-1 b`` or scalar zero."""
        if self.cov is None:
            return 0.0
        if self.cov.ndim < 2:
            return self.mean / self.cov
        return np.linalg.solve(self.cov, self.mean)

    def logdet_cov(self):
        """``log det B`` or zero."""
        if self.cov is None:
            return 0.0
        if self.cov.ndim < 2:
            return float(np.sum(np.log(np.broadcast_to(self.cov, (len(self.mean),)))))
        return float(np.linalg.slogdet(self.cov)[1])

    def __str__(self):
        return "MeanPriors with mean = {} and cov = {}".format(self.mean, self.cov)


# ---------------------------------------------------------------------------
# GPPriors container
# ---------------------------------------------------------------------------

class GPPriors:
    """Collection of priors for one GP.

    Holds per-slot distributions (correlation lengths, covariance and --
    when fit -- nugget) plus ``MeanPriors``.  Beyond the reference API it
    exposes ``packed()`` (flat ``codes, a, b, transform_codes`` arrays) and
    ``logp_raw(raw)`` (log density of a raw tensor).
    """

    def __init__(
        self,
        mean=None,
        corr=None,
        cov=None,
        nugget=None,
        n_corr=None,
        nugget_type="fit",
    ):
        if corr is None and n_corr is None:
            raise ValueError(
                "Must provide an argument for either corr or n_corr in GPPriors"
            )
        self.mean = mean
        self._n_corr = n_corr
        self.corr = corr
        self.cov = cov
        assert nugget_type in ("fit", "adaptive", "fixed", "pivot"), (
            "Bad value for nugget type in GPPriors"
        )
        self._nugget_type = nugget_type
        self.nugget = nugget

    # MultiOutputGP creates one GPPriors per output over the SAME inputs,
    # and each construction does O(D) scipy root solves -- memoize on the
    # input bytes so the solves run once per distinct design
    _default_cache = {}

    @classmethod
    def default_priors(cls, inputs, n_corr, nugget_type="fit", dist="invgamma"):
        """Data-driven defaults: correlation priors put 99% of mass between
        the min/max input spacing; fit nuggets get a small-value InvGamma
        prior."""
        assert nugget_type in ("fit", "adaptive", "fixed", "pivot")

        if isinstance(dist, str):
            try:
                import hashlib

                key = (
                    hashlib.sha1(
                        np.ascontiguousarray(np.asarray(inputs, dtype=np.float64))
                    ).hexdigest(),
                    int(n_corr),
                    nugget_type,
                    dist.lower(),
                )
            except (TypeError, ValueError):
                key = None
            if key is not None and key in cls._default_cache:
                corr_cached, nugget_cached = cls._default_cache[key]
                return cls(
                    mean=None, corr=list(corr_cached), cov=None,
                    nugget=nugget_cached, nugget_type=nugget_type,
                )
        else:
            key = None

        if isinstance(dist, str):
            dist_obj = {
                "lognormal": LogNormalPrior,
                "gamma": GammaPrior,
                "invgamma": InvGammaPrior,
            }.get(dist.lower())
            if dist_obj is None:
                raise TypeError(
                    "dist must be a prior distribution to construct default priors"
                )
        else:
            if not isinstance(dist, (LogNormalPrior, GammaPrior, InvGammaPrior)):
                raise TypeError(
                    "dist must be a prior distribution to construct default priors"
                )
            dist_obj = dist

        inputs = np.asarray(inputs)
        if inputs.shape[1] == n_corr:
            modified_inputs = np.transpose(inputs)
        elif n_corr == 1:
            modified_inputs = np.reshape(inputs, (1, -1))
        else:
            raise ValueError(
                "Number of correlation lengths not compatible with input array"
            )

        priors = [dist_obj.default_prior_corr(param) for param in modified_inputs]
        priors_updated = [
            p
            if isinstance(p, dist_obj)
            else InvGammaPrior.default_prior_corr_mode(param)
            for (p, param) in zip(priors, modified_inputs)
        ]

        nugget = InvGammaPrior.default_prior_nugget() if nugget_type == "fit" else None
        if key is not None:
            cls._default_cache[key] = (list(priors_updated), nugget)
        return cls(
            mean=None,
            corr=priors_updated,
            cov=None,
            nugget=nugget,
            nugget_type=nugget_type,
        )

    # -- attribute plumbing -------------------------------------------------

    @property
    def mean(self):
        return self._mean

    @mean.setter
    def mean(self, newmean):
        if newmean is None:
            self._mean = MeanPriors()
        elif isinstance(newmean, MeanPriors):
            self._mean = newmean
        else:
            try:
                self._mean = MeanPriors(*newmean)
            except TypeError:
                raise ValueError(
                    "Bad value for defining a MeanPriors object in GPPriors"
                )

    @property
    def n_mean(self):
        return self._mean.n_params

    @property
    def corr(self):
        return self._corr

    @corr.setter
    def corr(self, newcorr):
        if newcorr is None:
            assert self._n_corr is not None
            newcorr = [WeakPrior() for _ in range(self._n_corr)]
        try:
            list(newcorr)
        except TypeError:
            raise TypeError("corr must be a list of WeakPrior-derived objects")
        newcorr = [WeakPrior() if d is None else d for d in newcorr]
        for d in newcorr:
            assert isinstance(d, WeakPrior), (
                "all corr priors must be WeakPrior-derived objects"
            )
        if self._n_corr is not None:
            assert len(newcorr) == self._n_corr, (
                "corr must have length n_corr"
            )
        self._corr = list(newcorr)
        self._n_corr = len(self._corr)

    @property
    def n_corr(self):
        return self._n_corr

    @property
    def cov(self):
        return self._cov

    @cov.setter
    def cov(self, newcov):
        if newcov is None:
            newcov = WeakPrior()
        assert isinstance(newcov, WeakPrior), (
            "cov prior must be a WeakPrior-derived object"
        )
        self._cov = newcov

    @property
    def nugget_type(self):
        return self._nugget_type

    @property
    def nugget(self):
        return self._nugget

    @nugget.setter
    def nugget(self, newnugget):
        if self.nugget_type != "fit":
            self._nugget = None
            return
        if newnugget is None:
            newnugget = WeakPrior()
        assert isinstance(newnugget, WeakPrior), (
            "nugget prior must be a WeakPrior-derived object"
        )
        self._nugget = newnugget

    @property
    def n_params(self):
        return self.n_corr + 1 + int(self.nugget_type == "fit")

    def _slots(self):
        """Ordered (distribution, transform_code) pairs for the packed form."""
        slots = [(d, TRANSFORM_CORR) for d in self._corr]
        slots.append((self._cov, TRANSFORM_COV))
        if self.nugget_type == "fit":
            slots.append((self._nugget, TRANSFORM_COV))
        return slots

    def packed(self, dtype=None):
        """Flat numpy arrays (codes, a, b, transform_codes) for batched use."""
        slots = self._slots()
        codes = np.array([d.code for d, _ in slots], dtype=np.int32)
        a = np.array([d.packed_params[0] for d, _ in slots])
        b = np.array([d.packed_params[1] for d, _ in slots])
        tcodes = np.array([t for _, t in slots], dtype=np.int32)
        if dtype is not None:
            a = a.astype(dtype)
            b = b.astype(dtype)
        return codes, a, b, tcodes

    # -- tensor core --------------------------------------------------------

    def transformed_values(self, raw):
        """Map raw fitting parameters to per-slot transformed values."""
        raw = torch.as_tensor(raw, dtype=torch.float64)
        vals = [
            CorrTransform.transform(raw[: self.n_corr]),
            CovTransform.transform(raw[self.n_corr : self.n_corr + 1]),
        ]
        if self.nugget_type == "fit":
            vals.append(CovTransform.transform(raw[-1:]))
        return torch.cat(vals)

    def logp_raw(self, raw):
        """Total log prior density of the raw parameter vector."""
        codes, a, b, _ = self.packed()
        vals = self.transformed_values(raw)
        return torch.sum(
            dist_logp(
                torch.as_tensor(codes),
                torch.as_tensor(a, dtype=vals.dtype),
                torch.as_tensor(b, dtype=vals.dtype),
                vals,
            )
        )

    def sample_raw(self, generator, n=None):
        """float64 raw-parameter draws on the generator's device
        (``mogp_tpu/models/priors.py:730-744``): ``(P,)``, or ``(n, P)``
        when ``n`` is given (see :func:`dist_sample_raw`)."""
        codes, a, b, tcodes = self.packed()
        shape = (len(codes),) if n is None else (int(n), len(codes))

        def t(x, dt):
            return torch.as_tensor(x, dtype=dt, device=generator.device).expand(shape)

        return dist_sample_raw(t(codes, torch.int64), t(a, torch.float64),
                               t(b, torch.float64), t(tcodes, torch.int64), generator)

    # -- reference API parity ----------------------------------------------

    def _check_theta(self, theta):
        from .params import GPParams

        if not isinstance(theta, GPParams):
            raise TypeError(
                "theta must be a GPParams object when computing priors in GPPriors"
            )
        assert self.n_corr == theta.n_corr
        assert self.nugget_type == theta.nugget_type
        assert theta.get_data() is not None

    def logp(self, theta):
        """Log prior density of a ``GPParams`` object."""
        self._check_theta(theta)
        return float(self.logp_raw(theta.get_data()))

    def dlogpdtheta(self, theta):
        """Gradient w.r.t. raw parameters via autograd."""
        self._check_theta(theta)
        raw = torch.as_tensor(theta.get_data(), dtype=torch.float64)
        return torch.autograd.functional.jacobian(self.logp_raw, raw).numpy()

    def d2logpdtheta2(self, theta):
        """Diagonal of the Hessian via autograd."""
        self._check_theta(theta)
        raw = torch.as_tensor(theta.get_data(), dtype=torch.float64)
        hess = torch.autograd.functional.hessian(self.logp_raw, raw)
        return torch.diagonal(hess).numpy()

    def sample(self):
        """Host-side sample (numpy RNG)."""
        sample_pt = []
        for dist in self._corr:
            sample_pt.append(dist.sample(CorrTransform))
        sample_pt.append(self._cov.sample(CovTransform))
        if self.nugget_type == "fit":
            sample_pt.append(self._nugget.sample(CovTransform))
        return np.array(sample_pt)

    def sample_n(self, n):
        """``n`` host-side samples, shape ``(n, n_params)``; one vectorized
        draw per parameter slot (slot-major RNG order)."""
        cols = [dist.sample_n(CorrTransform, n) for dist in self._corr]
        cols.append(self._cov.sample_n(CovTransform, n))
        if self.nugget_type == "fit":
            cols.append(self._nugget.sample_n(CovTransform, n))
        return np.stack(cols, axis=1)

    def __str__(self):
        return "GPPriors with {} corr priors, cov prior {}, nugget type {}".format(
            self.n_corr, self._cov, self.nugget_type
        )


def max_spacing(input):
    """Total range of unique input values."""
    input = np.unique(np.asarray(input).flatten())
    if len(input) <= 1:
        return 0.0
    input_sorted = np.sort(input)
    return float(input_sorted[-1] - input_sorted[0])


def min_spacing(input):
    """Median spacing of unique input values."""
    input = np.unique(np.asarray(input).flatten())
    if len(input) <= 2:
        return 0.0
    return float(np.median(np.diff(np.sort(input))))
