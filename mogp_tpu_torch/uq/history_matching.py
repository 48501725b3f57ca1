"""History matching: implausibility computation and NROY/RO classification.

Port of ``mogp_tpu/uq/history_matching.py``, itself a parity
re-implementation of ``mogp_emulator/HistoryMatching.py``.  The expensive
part is the emulators' prediction over the query set.  For a fitted
``MultiOutputGP`` and at least :data:`_DEVICE_SWEEP_MIN_COORDS` query
points, :meth:`HistoryMatching._device_implausibility` runs it on the
emulators' device: per emulator group and query tile of
``MultiOutputGP._predict_groups`` (the fused prediction kernel on the
card's fused route), the variance sum, the implausibility and
``torch.topk`` over the outputs, so that only each
point's top-``(rank + 1)`` implausibilities reach the host; the rank
selection over the groups stays ``np.partition`` there.  Below it, with
explicit ``expectations``, unfit emulators or a single
``GaussianProcess``, the host path predicts and reduces in numpy.

With ``mesh=`` (a ``parallel.DeviceMesh``) the query points are split
over the mesh: each device runs the device sweep on its consecutive share
of them and the top-k merge is exact; the host path predicts through
``parallel.sharded_predict`` / ``sharded_predict_mogp``.

Spans (``utils/metrics.py``'s recorder): ``hm.get_implausibility`` is the
root of each wave; beneath it, on the device sweep, ``hm.inputs`` (the
host's handling of the query points and their copy to the device),
``hm.results`` (the wait for a group's top-k and its copy back) and
``hm.rank_select`` (the rank selection on the host).

Known reference quirk handled differently: with explicit multi-output
``expectations``, the reference sets ``ncoords`` from
``expectations[0].shape[0]`` (``HistoryMatching.py:649``), which is the
number of *outputs*; here ``ncoords`` is always the number of query
points.
"""

import numpy as np
import torch

from ..models.gp import GaussianProcessBase, PredictResult
from ..models.mogp import MultiOutputGPBase
from ..parallel.mesh import check_mesh, map_shards, split_rows
from ..utils import metrics

__all__ = ["HistoryMatching"]

# query count from which a MultiOutputGP sweep runs on the emulators'
# device (see the module doc).  The JAX package's 1 << 20 was tuned on a
# TPU.  On one H100 (80GB HBM3, 700 W), timing both paths at 2^0 to 2^22
# queries of the headline 64-output emulator (CHANGES.md, the UQ slice), the
# device sweep was the faster at every size from 2^7 on (1.02x at 2^7,
# 2.1x at 2^11, 16x at 2^20); below it the host path was by 2-12%, within
# 1.6-3.3 ms of fixed cost on both.
_DEVICE_SWEEP_MIN_COORDS = 1 << 7


@torch.no_grad()
def _implausibility_topk(tiles, obs_mean, obs_var, k):
    """Per query point, the top-``k`` implausibilities over one emulator
    group, tile by tile on the group's device.

    :param tiles: ``(mu, var)`` per query tile, ``(G, tile)`` each, in the
        emulators' own units (``MultiOutputGP._predict_groups``).
    :param obs_mean, obs_var: ``(G,)`` tensors on the device, in the same
        units: the observations and their variance plus the discrepancy.
    :returns: ``(k, m)`` tensor on the device, each column descending.
    """
    tops = []
    for mu, var in tiles:
        I = torch.abs(obs_mean[:, None] - mu) / torch.sqrt(var + obs_var[:, None])
        tops.append(torch.topk(I, k, dim=0).values)    # (k, tile) descending
    return torch.cat(tops, dim=1)


class HistoryMatching:
    """Implausibility-based calibration (``HistoryMatching.py:5-703``).

    ``I_i(x0) = |z_i - E(f_i(x0))| / sqrt(Var[z_i - E(f_i(x0))])``;
    query points whose rank-scored implausibility exceeds ``threshold``
    are Ruled Out (RO), the rest are Not Ruled Out Yet (NROY).
    """

    def __init__(self, gp=None, obs=None, coords=None, expectations=None,
                 threshold=3.0, mesh=None):
        self.gp = None
        self.obs = None
        self.coords = None
        self.expectations = None

        self.ndim = None
        self.ncoords = None
        self.threshold = None
        self.I = None
        self.NROY = None
        self.RO = None
        self.mesh = check_mesh(mesh)

        if self.check_gp(gp):
            self.set_gp(gp)
        if self.check_obs(obs):
            self.set_obs(obs)
        if self.check_coords(coords):
            self.set_coords(coords)
        if self.check_expectations(expectations):
            self.set_expectations(expectations)
        if self.check_threshold(threshold):
            self.set_threshold(threshold)

        self.update()

    # -- core computation ---------------------------------------------------

    def get_n_obs(self):
        return len(self.obs[0])

    def _select_expectations(self):
        """Choose between provided expectations and GP predictions
        (``HistoryMatching.py:155-196``)."""
        use_coord_gp = self.check_coords(self.coords) and self.check_gp(self.gp)
        use_expectations = self.check_expectations(self.expectations)
        if use_coord_gp and use_expectations:
            raise ValueError(
                "Multiple valid parameter combinations are set. Previously set "
                "parameters can be removed by setting them to None"
            )
        if not use_coord_gp and not use_expectations:
            raise ValueError(
                "Expectations are not provided, nor is a GP and coordinates. "
                "Must set one in order to perform History Matching"
            )
        if self.ncoords is None:
            raise ValueError(
                "ncoords is not set despite a valid parameter combination being found."
            )
        if use_coord_gp:
            if self.mesh is not None:
                from ..parallel.sharded import sharded_predict, sharded_predict_mogp

                if isinstance(self.gp, MultiOutputGPBase):
                    mu, var = sharded_predict_mogp(self.gp, self.coords, mesh=self.mesh)
                else:
                    mu, var = sharded_predict(self.gp, self.coords, mesh=self.mesh)
                return PredictResult(mean=mu, unc=var, deriv=None)
            return self.gp.predict(self.coords)
        return self.expectations

    def get_implausibility(self, discrepancy=0.0, rank=1):
        """Implausibility for all query points
        (``HistoryMatching.py:197-289``).

        ``rank`` selects the rank-th largest per-output implausibility as
        the multi-output score (0 = maximum, 1 = second largest, ...).
        """
        with metrics.span("hm.get_implausibility", points=self.ncoords):
            if not self.check_obs(self.obs):
                raise ValueError(
                    "implausibility calculation requires that the observation "
                    "value is set. This can be done using the set_obs method."
                )
            assert np.all(np.asarray(discrepancy) >= 0.0), (
                "Model discrepancy variance cannot be negative"
            )
            discrepancy = np.atleast_1d(discrepancy)

            if self._device_sweep_applies():
                self.I = self._device_implausibility(discrepancy, rank)
                return self.I

            expectations = self._select_expectations()

            n_obs = self.get_n_obs()
            assert n_obs == np.atleast_2d(expectations[0]).shape[0]
            assert n_obs == np.atleast_2d(expectations[1]).shape[0]

            if n_obs == 1:
                rank = 0
            assert rank >= 0, "rank must be a non-negative integer"
            assert rank < n_obs, "rank must be less than the number of observations"

            means = np.atleast_2d(np.asarray(expectations[0]))
            variances = np.atleast_2d(np.asarray(expectations[1]))

            Vs = np.zeros((n_obs, self.ncoords))
            Vs += variances
            Vs += discrepancy[:, np.newaxis]
            Vs += self.obs[1][:, np.newaxis]
            I = np.abs(self.obs[0][:, np.newaxis] - means) / np.sqrt(Vs)
            # rank-k selection in O(n) via partition (HistoryMatching.py:279-286)
            self.I = np.partition(I, n_obs - rank - 1, axis=0)[n_obs - rank - 1]
            return self.I

    def _device_sweep_applies(self):
        """Whether :meth:`get_implausibility` takes the device sweep: a
        fitted ``MultiOutputGP`` with coords, one observation per emulator
        and no ``expectations``, at :data:`_DEVICE_SWEEP_MIN_COORDS` query
        points or more.  Otherwise the host path predicts and reduces in
        numpy (with NaN rows for unfit emulators, and its own shape
        assertions)."""
        gp = self.gp
        return (
            isinstance(gp, MultiOutputGPBase)
            and self.check_coords(self.coords)
            and not self.check_expectations(self.expectations)
            and self.ncoords is not None
            and self.ncoords >= _DEVICE_SWEEP_MIN_COORDS
            and not gp.get_indices_not_fit()
            and self.get_n_obs() == gp.n_emulators
        )

    def _device_implausibility(self, discrepancy, rank):
        """The device sweep (see :meth:`_device_sweep_applies`).

        Brings back only each group's per-point top-(rank+1)
        implausibilities (:func:`_implausibility_topk`); the global rank
        selection over the union of the groups' top-k equals the
        reference's full ``np.partition`` because the global (rank+1)-th
        largest is always within some group's top-(rank+1).  With a mesh,
        each device sweeps its share of the points (:meth:`_sweep_topk`).
        """
        gp = self.gp
        n_obs = self.get_n_obs()
        if n_obs == 1:
            rank = 0
        assert rank >= 0, "rank must be a non-negative integer"
        assert rank < n_obs, "rank must be less than the number of observations"

        disc_full = np.broadcast_to(
            np.atleast_1d(discrepancy), (n_obs,)
        ).astype(np.float64)
        with metrics.span("hm.inputs"):
            coords = gp._process_inputs(self.coords)
        if self.mesh is None:
            allk = self._sweep_topk(coords, disc_full, rank + 1)
        else:
            parts = split_rows(coords.shape[0], self.mesh.shape[self.mesh.axis_names[0]])
            allk = np.concatenate(map_shards(
                self.mesh, lambda i, d: self._sweep_topk(coords[parts[i]], disc_full, rank + 1, d),
                n_items=len(parts)), axis=1)
        with metrics.span("hm.rank_select"):
            return np.partition(allk, allk.shape[0] - rank - 1, axis=0)[
                allk.shape[0] - rank - 1
            ]

    def _sweep_topk(self, coords, disc_full, k, device=None):
        """Each emulator group's top-``k`` implausibilities at ``coords``,
        stacked ``(sum of the groups' k, m)`` float64, swept on ``device``
        (default the emulators')."""
        tops = []
        groups = self.gp._predict_groups(coords, list(range(self.gp.n_emulators)),
                                         device=device)
        while True:
            # a group's next item makes its query tensor on the device
            with metrics.span("hm.inputs"):
                group = next(groups, None)
            if group is None:
                break
            rows, tiles, scale, shift = group
            # I is the same in a standardized emulator's own units, with
            # the observations mapped there in float64
            em0 = self.gp.emulators[rows[0]]

            def to_device(x):
                return torch.as_tensor(x, dtype=em0._dtype,
                                       device=em0._device if device is None else device)

            top = _implausibility_topk(
                tiles, to_device((self.obs[0][rows] - shift) / scale),
                to_device((self.obs[1][rows] + disc_full[rows]) / scale**2), min(k, len(rows)),
            )
            with metrics.span("hm.results"):
                tops.append(top.to("cpu", torch.float64).numpy())
        return np.concatenate(tops, axis=0)

    def get_NROY(self, discrepancy=0.0, rank=1):
        """Indices not yet ruled out (``HistoryMatching.py:291-316``)."""
        if self.I is None:
            self.get_implausibility(discrepancy, rank)
        self.NROY = list(np.where(self.I <= self.threshold)[0])
        return self.NROY

    def get_RO(self, discrepancy=0.0, rank=1):
        """Indices ruled out (``HistoryMatching.py:317-342``)."""
        if self.I is None:
            self.get_implausibility(discrepancy, rank)
        self.RO = list(np.where(self.I > self.threshold)[0])
        return self.RO

    # -- setters (``HistoryMatching.py:343-631``) ---------------------------

    def set_gp(self, gp):
        if not self.check_gp(gp):
            raise TypeError("bad input for set_gp - expects a GaussianProcess object.")
        self.gp = gp

    def set_obs(self, obs):
        if not self.check_obs(obs):
            raise TypeError("bad input for set_obs")
        if isinstance(obs, (float, int)):
            self.obs = [np.array([float(obs)]), np.array([0.0])]
        else:
            obs = list(obs)
            if len(obs) == 1:
                self.obs = [np.atleast_1d(np.asarray(obs[0], dtype=np.float64)),
                            np.zeros(np.atleast_1d(obs[0]).shape)]
            else:
                self.obs = [
                    np.atleast_1d(np.asarray(a, dtype=np.float64)) for a in obs
                ]
                assert self.obs[0].shape == self.obs[1].shape, (
                    "observation means and variances must have the same shape"
                )

    def set_coords(self, coords):
        if not self.check_coords(coords) and coords is not None:
            raise TypeError(
                "bad input for set_coords - expected coords in the form of a "
                "list or 1D or 2D ndarray of numerical values"
            )
        if isinstance(coords, np.ndarray):
            if coords.ndim == 1:
                self.coords = np.reshape(coords, [-1, 1])
            else:
                self.coords = coords
        elif isinstance(coords, list):
            self.coords = np.reshape(np.asarray(coords, dtype=np.float64), [-1, 1])
        else:
            self.coords = None
        self.update()

    def set_expectations(self, expectations):
        if not self.check_expectations(expectations) and expectations is not None:
            raise TypeError(
                "bad input for set_expectations - expected a Tuple of 3 ndarrays."
            )
        self.expectations = expectations
        self.update()

    def set_threshold(self, threshold):
        if not self.check_threshold(threshold):
            raise TypeError("bad input for set_threshold - expected a float")
        self.threshold = float(threshold)

    def status(self):
        print(str(self))

    # -- checks -------------------------------------------------------------

    def check_gp(self, gp):
        return isinstance(gp, (GaussianProcessBase, MultiOutputGPBase))

    def check_obs(self, obs):
        if obs is None:
            return False
        if isinstance(obs, (float, int)):
            return True
        try:
            obs_list = list(obs)
        except TypeError:
            raise TypeError(
                "bad input type for HistoryMatching - the specified observations "
                "must be a float or a list of up to two floats/arrays"
            )
        if len(obs_list) > 2 or len(obs_list) == 0:
            raise ValueError(
                "bad input for HistoryMatching, the obs parameter must be a "
                "float or a list of up to two entries"
            )
        if len(obs_list) == 2:
            var = np.atleast_1d(np.asarray(obs_list[1], dtype=np.float64))
            assert np.all(var >= 0.0), "variance in observations cannot be negative"
        return True

    def check_coords(self, coords):
        if coords is None:
            return False
        if isinstance(coords, np.ndarray):
            return coords.ndim <= 2
        if isinstance(coords, list):
            return True
        return False

    def check_expectations(self, expectations):
        if expectations is None:
            return False
        if not isinstance(expectations, (PredictResult, tuple)):
            return False
        if not all(
            (
                isinstance(np.asarray(expectations[0]), np.ndarray),
                isinstance(np.asarray(expectations[1]), np.ndarray),
            )
        ):
            raise TypeError(
                "bad input type for HistoryMatching - expected expectation "
                "values in the form of a PredictResult object with mean and "
                "uncertainty set."
            )
        if not np.asarray(expectations[0]).shape == np.asarray(expectations[1]).shape:
            raise ValueError(
                "bad input for HistoryMatching - mean and variance "
                "expectations do not match"
            )
        assert np.all(np.asarray(expectations[1]) >= 0.0), (
            "all variances must be non-negative"
        )
        return True

    def check_threshold(self, threshold):
        if threshold is None:
            return False
        try:
            test = float(threshold)
            assert test >= 0.0, "threshold must be non-negative"
            return True
        except TypeError:
            return False

    def update(self):
        """Recompute derived ndim/ncoords (``HistoryMatching.py:633-650``)."""
        if self.check_coords(self.coords):
            self.ndim = self.coords.shape[1]
            self.ncoords = self.coords.shape[0]
        elif self.check_expectations(self.expectations):
            # number of query points (last axis for multi-output)
            self.ncoords = np.atleast_2d(np.asarray(self.expectations[0])).shape[-1]

    def __str__(self):
        return (
            "History Matching tools created with:\n"
            + "Gaussian Process: {}\n".format(self.gp)
            + "Observations: {}\n".format(self.obs)
            + "Coords: {}\n".format(
                None if self.coords is None else self.coords.shape
            )
            + "Expectations: {}\n".format(
                None
                if self.expectations is None
                else np.asarray(self.expectations[0]).shape
            )
            + "No. of Input Dimensions: {}\n".format(self.ndim)
            + "No. of Descrete Expectation Values: {}\n".format(self.ncoords)
            + "I_threshold: {}".format(self.threshold)
        )
