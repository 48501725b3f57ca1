"""Hyperparameter container for GP emulators (port of ``mogp_tpu/models/params.py``).

Host numpy, as in the JAX package.  User-facing mirror of the reference ``GPParams``
(``mogp_emulator/GPParams.py:215-555``): wraps the raw fitting-parameter
vector with the data layout ``[corr..., cov, (nugget)]`` and exposes the
transformed (interpretable) values.  Mean parameters are stored separately
because they are solved analytically at fit time
(``GaussianProcess.py:669``).

The *functional* core of the framework operates directly on raw parameter
arrays; this class exists for API parity and interactive inspection.
"""

import numpy as np

from ..ops.transforms import CorrTransform, CovTransform

__all__ = ["GPParams", "_process_nugget"]


def _process_nugget(nugget):
    """Convert a nugget specification to ``(value, type)``.

    Reference: ``GPParams.py:163-196``.
    """
    if not isinstance(nugget, (str, float)):
        try:
            nugget = float(nugget)
        except TypeError:
            raise TypeError(
                "nugget parameter must be a string or a non-negative float"
            )

    if isinstance(nugget, str):
        if nugget not in ("adaptive", "fit", "pivot"):
            raise ValueError(
                "bad value of nugget, must be a float or 'adaptive', 'pivot', or 'fit'"
            )
        return None, nugget
    if nugget < 0.0:
        raise ValueError("nugget parameter must be non-negative")
    return float(nugget), "fixed"


class GPParams:
    """Reference-parity hyperparameter container (``GPParams.py:215``)."""

    def __init__(self, n_mean=0, n_corr=1, nugget="fit"):
        assert n_mean >= 0, "Number of mean parameters must be nonnegative"
        assert n_corr >= 1, "Number of correlation parameters must be positive"
        self.n_mean = int(n_mean)
        self.n_corr = int(n_corr)
        self._nugget, self._nugget_type = _process_nugget(nugget)
        self._mean = np.array([]) if self.n_mean == 0 else None
        self._data = None

    # -- shape bookkeeping --------------------------------------------------

    @property
    def n_params(self):
        """Correlation lengths + covariance + (nugget if fit)."""
        return self.n_corr + 1 + int(self.nugget_type == "fit")

    @property
    def cov_index(self):
        """Location of the covariance parameter (``GPParams.py:377``)."""
        return -2 if self.nugget_type == "fit" else -1

    @property
    def nugget_type(self):
        return self._nugget_type

    # -- mean ---------------------------------------------------------------

    @property
    def mean(self):
        return self._mean

    @mean.setter
    def mean(self, new_mean):
        if new_mean is None:
            if self.n_mean > 0:
                self._mean = None
        else:
            new_mean = np.reshape(np.asarray(new_mean, dtype=np.float64), (-1,))
            assert new_mean.shape == (self.n_mean,), "Bad shape for new mean parameters"
            self._mean = np.copy(new_mean)

    # -- correlation ----------------------------------------------------------

    @property
    def corr_raw(self):
        """Raw correlation parameters (consumed directly by kernels)."""
        if self._data is None:
            return None
        return self._data[: self.n_corr]

    @property
    def corr(self):
        """Correlation lengths ``l = exp(-theta/2)``."""
        if self._data is None:
            return None
        return np.asarray(CorrTransform.transform(self.corr_raw))

    @corr.setter
    def corr(self, new_corr):
        if new_corr is None:
            raise ValueError(
                "Resetting correlation lengths requires resetting the full data array"
            )
        if self._data is None:
            raise ValueError(
                "Must set full data array before modifying individual parameters"
            )
        new_corr = np.reshape(np.asarray(new_corr, dtype=np.float64), (-1,))
        assert np.all(new_corr > 0.0), "Correlation parameters must all be positive"
        assert new_corr.shape == (self.n_corr,)
        self._data[: self.n_corr] = np.asarray(CorrTransform.inv_transform(new_corr))

    # -- covariance -----------------------------------------------------------

    @property
    def cov(self):
        """Covariance ``sigma^2 = exp(theta)``."""
        if self._data is None:
            return None
        return float(CovTransform.transform(self._data[self.cov_index]))

    @cov.setter
    def cov(self, new_cov):
        if self._data is None:
            raise ValueError(
                "Must set full data array before modifying individual parameters"
            )
        new_cov = float(np.reshape(np.asarray(new_cov), (-1,))[0])
        assert new_cov > 0.0, "Covariance must be positive"
        self._data[self.cov_index] = float(CovTransform.inv_transform(new_cov))

    # -- nugget ---------------------------------------------------------------

    @property
    def nugget(self):
        """Nugget variance (handling depends on nugget type,
        ``GPParams.py:428-460``)."""
        if self.nugget_type in ("fixed", "adaptive", "pivot"):
            return self._nugget
        if self._data is None:
            return None
        return float(CovTransform.transform(self._data[-1]))

    @nugget.setter
    def nugget(self, new_nugget):
        if self.nugget_type == "pivot":
            if new_nugget is not None:
                raise ValueError(
                    "Cannot explicitly modify nugget for 'pivot' nugget type"
                )
        elif self.nugget_type == "fixed":
            if not np.allclose(self._nugget, new_nugget):
                raise ValueError(
                    "Cannot explicitly modify nugget for 'fixed' nugget type"
                )
        elif self.nugget_type == "adaptive":
            if new_nugget is None:
                self._nugget = None
            else:
                new_nugget = float(np.reshape(np.asarray(new_nugget), (-1,))[0])
                assert new_nugget >= 0.0, "nugget cannot be negative"
                self._nugget = new_nugget
        else:  # fit
            if new_nugget is None:
                raise ValueError(
                    "Cannot reset fit nugget individually, must reset full data array"
                )
            if self._data is None:
                raise ValueError(
                    "Must initialize parameters before setting individual values"
                )
            new_nugget = float(np.reshape(np.asarray(new_nugget), (-1,))[0])
            assert new_nugget >= 0.0, "Nugget must be positive"
            self._data[-1] = float(CovTransform.inv_transform(new_nugget))

    # -- raw data -------------------------------------------------------------

    def get_data(self):
        return self._data

    def set_data(self, new_params):
        """Set the raw fitting parameters; resets mean and adaptive nugget
        (``GPParams.py:489-512``)."""
        if new_params is None:
            self._data = None
        else:
            new_params = np.asarray(new_params, dtype=np.float64)
            assert self.same_shape(new_params), (
                "Bad shape for new data; expected {} parameters".format(self.n_params)
            )
            self._data = np.copy(new_params)
        self.mean = None
        if self.nugget_type == "adaptive":
            self._nugget = None

    def same_shape(self, other):
        """Shape-compatibility check (``GPParams.py:514-546``)."""
        if isinstance(other, np.ndarray):
            return other.shape == (self.n_params,)
        if isinstance(other, GPParams):
            return (
                self.n_mean == other.n_mean
                and self.n_corr == other.n_corr
                and self.nugget_type == other.nugget_type
            )
        try:
            arr = np.asarray(other, dtype=np.float64)
        except (TypeError, ValueError):
            raise ValueError(
                "other must be a numpy array or another GPParams object "
                "in GPParams.same_shape"
            )
        return arr.shape == (self.n_params,)

    def __str__(self):
        if self._data is None:
            return "GPParams with: data = None"
        return (
            "GPParams with:"
            + "\nmean = {}".format(self.mean)
            + "\ncorrelation = {}".format(self.corr)
            + "\ncovariance = {}".format(self.cov)
            + "\nnugget = {}".format(self.nugget)
        )
