"""Multi-output GP emulator: outputs as a lanes axis.

Port of ``mogp_tpu/models/mogp.py``.  Emulators that share a
configuration signature (kernel, nugget handling, mean specification,
prior layout) are stacked along the lanes axis and go through the lane-
batched core of ``models/gp.py`` together: one ``gp_fit`` per signature
group in :meth:`MultiOutputGP.fit`, one prediction per group in
:meth:`MultiOutputGP.predict`.

The public surface (``emulators`` list, ``get_indices_fit`` /
``get_indices_not_fit``, NaN predictions via ``allow_not_fit``) matches
the reference.  Unlike the reference, ``standardize`` (one flag, or one
per emulator) is taken and passed to each ``GaussianProcess``.
"""

import hashlib
import warnings

import numpy as np
import torch

from ..ops.kernels import KernelBase
from ..parallel.mesh import to_device
from .gp import (
    GaussianProcess,
    PredictResult,
    _host_summary,
    _query_tile,
    cat_lanes,
    gp_fit,
    gp_predict,
    take_lanes,
)
from .meanfun import design_matrix_fn
from .priors import GPPriors

__all__ = ["MultiOutputGP", "MultiOutputGPBase"]


def _store_rows(out, rows, values, scale, shift=None):
    """``out[rows] = values * scale (+ shift)`` in float64, ``values`` a
    tensor of the lanes' results.  They cross to the host in their own type
    (half the bytes of float64 for float32) and are widened there, in place
    into the output rows when those are consecutive: the same float64
    values as a cast on the device, without a second copy of them."""
    host = values.cpu().numpy()
    if rows == list(range(rows[0], rows[0] + len(rows))):
        dst = out[rows[0]:rows[0] + len(rows)]
        np.multiply(host, scale, out=dst)
        if shift is not None:
            dst += shift
    else:
        out[rows] = host * scale + (0.0 if shift is None else shift)


def _cat_tiles(tiles):
    """One ``(mu, var)`` from the query tiles of
    :meth:`MultiOutputGP._predict_groups`."""
    parts = list(tiles)
    if len(parts) == 1:
        return parts[0]
    mu = torch.cat([p[0] for p in parts], dim=-1)
    return mu, None if parts[0][1] is None else torch.cat([p[1] for p in parts], dim=-1)


def _group_tiles(arts, data, testing, dmtest, kernel, nugget_type, tile, **kw):
    """``gp_predict`` of one group over consecutive query tiles of
    ``tile`` points (all at once for 0), each when it is asked for."""
    if not tile:
        yield gp_predict(arts, data, testing, dmtest, kernel, nugget_type, **kw)
        return
    for c0 in range(0, testing.shape[0], tile):
        yield gp_predict(arts, data, testing[c0:c0 + tile], dmtest[c0:c0 + tile], kernel,
                         nugget_type, **kw)


class MultiOutputGPBase:
    """Base class for multi-output GPs."""


class MultiOutputGP(MultiOutputGPBase):
    """Multiple independent GP emulators over shared inputs.

    ``device`` and ``dtype`` apply to every emulator, and ``standardize``
    (one flag or a list of one per emulator) to each (see
    :class:`GaussianProcess`).
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
        if inputdict:
            warnings.warn(
                "The inputdict interface for mean functions has been deprecated.",
                DeprecationWarning,
            )

        inputs = np.asarray(inputs, dtype=np.float64)
        targets = np.asarray(targets, dtype=np.float64)
        if inputs.ndim == 1:
            inputs = np.reshape(inputs, (-1, 1))
        if targets.ndim == 1:
            targets = np.reshape(targets, (1, -1))
        elif targets.ndim != 2:
            raise ValueError("targets must be either a 1D or 2D array")
        if inputs.ndim != 2:
            raise ValueError("inputs must be either a 1D or 2D array")
        if inputs.shape[0] != targets.shape[1]:
            raise ValueError(
                "the first dimension of inputs must be the same length as "
                "the second dimension of targets (or first if targets is 1D)"
            )

        self._n_emulators = targets.shape[0]
        self._n = inputs.shape[0]
        self._D = inputs.shape[1]

        if not isinstance(mean, list):
            mean = self.n_emulators * [mean]
        assert len(mean) == self.n_emulators

        if isinstance(kernel, str) or issubclass(type(kernel), KernelBase):
            kernel = self.n_emulators * [kernel]
        assert isinstance(kernel, list)
        assert len(kernel) == self.n_emulators

        if isinstance(priors, (GPPriors, dict)) or priors is None:
            priorslist = self.n_emulators * [priors]
        else:
            priorslist = list(priors)
            assert len(priorslist) == self.n_emulators, (
                "Bad length for list provided for priors to MultiOutputGP"
            )

        if isinstance(nugget, (str, float)):
            nugget = self.n_emulators * [nugget]
        assert isinstance(nugget, list)
        assert len(nugget) == self.n_emulators

        if not isinstance(standardize, list):
            standardize = self.n_emulators * [standardize]
        assert len(standardize) == self.n_emulators

        self.emulators = [
            GaussianProcess(inputs, single_target, m, k, p, n, standardize=st,
                            device=device, dtype=dtype)
            for (single_target, m, k, p, n, st) in zip(
                targets, mean, kernel, priorslist, nugget, standardize
            )
        ]

    # -- properties ---------------------------------------------------------

    @property
    def inputs(self):
        return self.emulators[0].inputs

    @property
    def targets(self):
        return np.array([em.targets for em in self.emulators])

    @property
    def D(self):
        return self._D

    @property
    def n(self):
        return self._n

    @property
    def n_params(self):
        return [em.n_params for em in self.emulators]

    @property
    def n_emulators(self):
        return self._n_emulators

    def reset_fit_status(self):
        for em in self.emulators:
            em.theta = None

    def _process_inputs(self, inputs):
        return self.emulators[0]._process_inputs(inputs)

    # -- grouping for batched execution -------------------------------------

    @staticmethod
    def _mean_sig(em):
        """Hashable identity of an emulator's mean specification.  The
        mean must be part of the batch signature: grouped prediction
        evaluates ONE design matrix for the whole group, so two emulators
        with different formulas of the same width (``"x[0]"`` vs
        ``"x[1]"``) must not batch together.  Memoized on the emulator."""
        key = getattr(em, "_mean_sig_cache", None)
        if key is None:
            mean = em._mean
            if mean is None or isinstance(mean, str):
                key = ("s", mean)
            elif callable(mean):
                key = ("c", id(mean))
            else:
                key = ("a", hashlib.sha1(
                    np.ascontiguousarray(
                        np.asarray(mean, dtype=np.float64)
                    ).tobytes()
                ).hexdigest())
            em._mean_sig_cache = key
        return key

    def _signature(self, em):
        """Emulators with equal signatures stack into one lanes batch."""
        return (
            em.kernel,
            em.nugget_type,
            em.n_mean,
            self._mean_sig(em),
            em._prior_codes,
        )

    def _groups(self, emulators=None):
        groups = {}
        emulators = self.emulators if emulators is None else emulators
        for idx, em in enumerate(emulators):
            groups.setdefault(self._signature(em), []).append(idx)
        return groups

    # -- prediction ---------------------------------------------------------

    def predict(
        self,
        testing,
        unc=True,
        deriv=False,
        include_nugget=True,
        full_cov=False,
        allow_not_fit=False,
        processes=None,
        max_batch_size=None,
    ):
        """Batched prediction over all emulators.

        ``processes`` is accepted for API parity and ignored: outputs are a
        lanes axis.  ``max_batch_size`` bounds device memory by tiling the
        query axis; default ``None`` auto-chunks very large sweeps.
        """
        testing = np.asarray(testing, dtype=np.float64)
        if self.D == 1 and testing.ndim == 1:
            testing = np.reshape(testing, (-1, 1))
        elif testing.ndim == 1:
            testing = np.reshape(testing, (1, len(testing)))
        assert testing.ndim == 2, "testing must be a 2D array"
        n_testing, D = testing.shape
        assert D == self.D, (
            "second dimension of testing must be the same as the number of "
            "input parameters"
        )
        if deriv:
            warnings.warn(
                "Prediction derivatives have been deprecated and are no "
                "longer supported",
                DeprecationWarning,
            )

        unfit = self.get_indices_not_fit()
        if unfit and not allow_not_fit:
            raise ValueError(
                "hyperparameters have not been fit for emulators {}".format(unfit)
            )

        # every row is written once: NaN for the unfit emulators, the
        # predictions for the others
        mean_out = np.empty((self.n_emulators, n_testing))
        unc_out = np.empty((self.n_emulators, n_testing) + ((n_testing,) if full_cov else ()))
        mean_out[unfit] = np.nan
        unc_out[unfit] = np.nan

        fit_indices = [i for i in range(self.n_emulators) if i not in set(unfit)]
        for rows, tiles, scale, shift in self._predict_groups(
            testing, fit_indices, unc=unc, include_nugget=include_nugget, full_cov=full_cov,
            max_batch_size=max_batch_size,
        ):
            mu, var = _cat_tiles(tiles)
            _store_rows(mean_out, rows, mu, scale[:, None], shift[:, None])
            if unc:
                var_scale = scale[:, None, None] ** 2 if full_cov else scale[:, None] ** 2
                _store_rows(unc_out, rows, var, var_scale)

        return PredictResult(
            mean=mean_out, unc=(unc_out if unc else None), deriv=None
        )

    def _predict_groups(self, testing, indices, unc=True, include_nugget=True, full_cov=False,
                        max_batch_size=None, device=None):
        """The one assembly of a prediction of the fitted emulators
        ``indices`` at ``testing`` (2D float64 numpy, or a tensor, whose
        design matrix is then built on the device by ``design_matrix_fn``),
        for :meth:`predict`, ``HistoryMatching``'s device sweep, SMC's
        implausibility and the sharded prediction (``parallel/``), on
        ``device`` (default the emulators'; the training data and the
        artifacts are copied there).  Per signature group it
        yields ``(rows, tiles, scale, shift)``:

        * ``rows``: the group's emulator indices;
        * ``tiles``: ``(mu, var)`` on the group's device over consecutive
          query tiles (one when the query axis is not chunked, always one
          with ``full_cov``), each computed when it is asked for, in the
          emulators' own units; ``var`` is ``None`` unless ``unc``;
        * ``scale``, ``shift``: ``(G,)`` float64, the map of standardized
          emulators to their targets' units, ``mu * scale + shift`` and
          ``var * scale**2``.  The consumer applies it in float64, not the
          lanes' float32: :meth:`predict` on the host to the results, the
          sweep to the observations.
        """
        for group in self._groups([self.emulators[i] for i in indices]).values():
            rows = [indices[i] for i in group]
            ems = [self.emulators[i] for i in rows]
            em0 = ems[0]
            dev = em0._device if device is None else device
            data = to_device(cat_lanes([em._data for em in ems]), dev)
            tile = 0 if full_cov else _query_tile(testing.shape[0], max_batch_size, data,
                                                  em0.kernel, em0.nugget_type)
            if isinstance(testing, torch.Tensor):
                x = testing.to(dev, em0._dtype)
                dm = design_matrix_fn(em0._mean, em0._mean_state)(x)
            else:
                x = torch.as_tensor(testing, dtype=em0._dtype, device=dev)
                dm = torch.as_tensor(em0.get_design_matrix(testing), dtype=em0._dtype,
                                     device=dev)
            tiles = _group_tiles(
                to_device(cat_lanes([em._artifacts for em in ems]), dev), data, x, dm, em0.kernel,
                em0.nugget_type, tile, unc=bool(unc), include_nugget=bool(include_nugget),
                full_cov=bool(full_cov),
            )
            yield (rows, tiles, np.array([em._t_std for em in ems]),
                   np.array([em._t_mean for em in ems]))

    def __call__(self, testing, processes=None):
        return self.predict(testing, unc=False, deriv=False, processes=processes)[0]

    # -- fitting ------------------------------------------------------------

    def fit(self, thetas):
        """Fit all emulators at given hyperparameters.

        ``thetas`` is one raw vector per emulator: a ``(n_emulators,
        n_params)`` array or a list of arrays (or ``GPParams``).  Batched
        ``gp_fit`` calls run per signature group (see :meth:`_fit_lanes`).
        """
        thetas = list(thetas)
        assert len(thetas) == self.n_emulators, "need one theta per emulator"
        self._fit_lanes(range(self.n_emulators), thetas)

    def _fit_lanes(self, indices, thetas, device=None):
        """Fit emulators ``indices`` at ``thetas`` (same order) on ``device``
        (default the emulators'; the artifacts are put back on each
        emulator's device): :meth:`_install` of :meth:`_lane_artifacts`.
        This is the one path of ``fit``, ``load_mogp`` and the MAP refit."""
        self._install(self._lane_artifacts(indices, thetas, device))

    def _lane_artifacts(self, indices, thetas, device=None):
        """The fit artifacts of emulators ``indices`` at ``thetas``: per
        signature group, batched ``gp_fit`` calls of at most
        ``fitting._max_lanes`` lanes each (the device-memory budget), one
        host transfer per call, on ``device`` (default the emulators').  At
        n >= ``PROGRESSIVE_LADDER_MIN_N`` the jitter ladder is progressive,
        so each lane stops at the rung a single ``GaussianProcess.fit``
        stops at; below it every rung is factored at once.

        :returns: ``[(rows, raws, arts, summary)]``, one per call: the
            emulator indices, their raw thetas, the ``FitArtifacts`` of
            their lanes and the ``_host_summary`` rows.
        """
        from .fitting import _max_lanes  # fitting imports this module

        indices = list(indices)
        ems = [self.emulators[i] for i in indices]
        fits = []
        for group in self._groups(ems).values():
            step = _max_lanes(ems[group[0]])
            for c0 in range(0, len(group), step):
                chunk = group[c0:c0 + step]
                chunk_ems = [ems[i] for i in chunk]
                raws = [em._coerce_theta(thetas[i]) for em, i in zip(chunk_ems, chunk)]
                em0 = chunk_ems[0]
                dev = em0._device if device is None else device
                arts = gp_fit(
                    torch.as_tensor(np.stack(raws), dtype=em0._dtype, device=dev),
                    to_device(cat_lanes([em._data for em in chunk_ems]), dev),
                    em0.kernel,
                    em0.nugget_type,
                )
                fits.append(([indices[i] for i in chunk], raws, arts, _host_summary(arts)))
        return fits

    def _install(self, fits):
        """Set the artifacts of :meth:`_lane_artifacts` on their emulators,
        each lane on its emulator's device (one copy of a call's artifacts
        a device, of which each lane takes its slice)."""
        for rows, raws, arts, summary in fits:
            on_device = {}
            for lane, (row, raw) in enumerate(zip(rows, raws)):
                em = self.emulators[row]
                if em._device not in on_device:
                    on_device[em._device] = to_device(arts, em._device)
                em._set_fit_artifacts(
                    raw, take_lanes(on_device[em._device], slice(lane, lane + 1)), summary[lane])

    def fit_emulator(self, index, theta):
        self.emulators[index].fit(theta)

    # -- fit-status bookkeeping ---------------------------------------------

    def get_indices_fit(self):
        return [
            idx
            for idx, em in enumerate(self.emulators)
            if em.theta.get_data() is not None
        ]

    def get_indices_not_fit(self):
        return [
            idx
            for idx, em in enumerate(self.emulators)
            if em.theta.get_data() is None
        ]

    def get_emulators_fit(self):
        return [em for em in self.emulators if em.theta.get_data() is not None]

    def get_emulators_not_fit(self):
        return [em for em in self.emulators if em.theta.get_data() is None]

    def __str__(self):
        return (
            "Multi-Output Gaussian Process with:\n"
            + str(self.n_emulators)
            + " emulators\n"
            + str(self.n)
            + " training examples\n"
            + str(self.D)
            + " input variables"
        )

