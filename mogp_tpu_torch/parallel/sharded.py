"""Sharded multi-output fitting and large prediction sweeps.

Port of ``mogp_tpu/parallel/sharded.py``.  The batch axes of the lane-
batched cores are split over a :class:`~.mesh.DeviceMesh`:

* :func:`sharded_fit_mogp` -- the MAP fit with the outputs split over the
  mesh (``fit_GP_MAP(mesh=)``: chunks of whole outputs, each output's
  restarts together);
* :func:`sharded_predict` / :func:`sharded_predict_mogp` -- the query
  points split over the mesh in fixed-shape super-chunks of ``tile *
  n_dev`` rows, the last padded with its edge row; every shard predicts its
  rows against the emulators' artifacts on its device, and the results come
  back as float64 host arrays.
"""

import numpy as np
import torch

from ..models.gp import _predict_tile_size, gp_predict
from .mesh import auto_mesh, check_mesh, map_shards, to_device

__all__ = ["sharded_fit_mogp", "sharded_predict", "sharded_predict_mogp"]


def sharded_fit_mogp(gp, n_tries=15, theta0=None, mesh=None, maxiter=200, gtol=None,
                     ftol=None, opt_ladder=None, race=True, refit=False):
    """MAP-fit every output of a ``MultiOutputGP`` with the outputs split
    over ``mesh`` (default :func:`~.mesh.auto_mesh`): ``fit_GP_MAP`` with
    ``mesh``, so the race, the chunking, the rescue and the refit are the
    unsharded path's, per signature group."""
    from ..models.fitting import fit_GP_MAP

    mesh = check_mesh(mesh) or auto_mesh()
    kwargs = dict(maxiter=maxiter, race=race)
    if gtol is not None:
        kwargs["gtol"] = gtol
    if ftol is not None:
        kwargs["ftol"] = ftol
    if opt_ladder is not None:
        kwargs["opt_ladder"] = opt_ladder
    return fit_GP_MAP(gp, n_tries=n_tries, theta0=theta0, mesh=mesh, refit=refit, **kwargs)


def _super_chunks(n_query, n_dev, max_batch_size, n_train=None, n_lanes=1):
    """Yield ``(start, stop, padded_len)`` fixed-shape query super-chunks.

    The per-device tile is the unchunked prediction's
    (``models.gp._predict_tile_size``); a super-chunk is ``tile * n_dev``
    rows, so every device gets the same number of rows, and every chunk has
    the same padded length.  Without a tile, one chunk padded to a multiple
    of ``n_dev``.
    """
    per_dev = -(-n_query // n_dev)
    tile = _predict_tile_size(per_dev, max_batch_size, n_train=n_train, n_lanes=n_lanes)
    if tile == 0:
        yield 0, n_query, n_dev * per_dev
        return
    chunk = tile * n_dev
    for c0 in range(0, n_query, chunk):
        yield c0, min(c0 + chunk, n_query), chunk


def _pad_rows(arr, total):
    """Pad a 2D host array to ``total`` rows by repeating the last row."""
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


def _testing(testing, D):
    testing = np.asarray(testing, dtype=np.float64)
    if testing.ndim == 1:
        testing = testing.reshape(-1, D) if D > 1 else testing.reshape(-1, 1)
    return testing


def sharded_predict_mogp(gp, testing, mesh=None, unc=True, include_nugget=True,
                         allow_not_fit=False, max_batch_size=None):
    """Predict a ``MultiOutputGP`` over query points split across ``mesh``
    (default :func:`~.mesh.auto_mesh`).

    Every shard predicts its rows of each super-chunk for all fitted
    outputs (``MultiOutputGP._predict_groups`` on the shard's device);
    ``max_batch_size`` bounds the rows a device holds at once.

    :returns: ``(means, variances)`` float64 ``(n_outputs, n_query)`` host
        arrays (``variances`` ``None`` unless ``unc``); the rows of unfit
        emulators are NaN under ``allow_not_fit``, which otherwise raises.
    """
    mesh = check_mesh(mesh) or auto_mesh()
    n_dev = mesh.shape[mesh.axis_names[0]]
    testing = _testing(testing, gp.D)
    n_query = testing.shape[0]

    unfit = set(gp.get_indices_not_fit())
    if unfit and not allow_not_fit:
        raise ValueError(
            "hyperparameters have not been fit for emulators {}".format(sorted(unfit))
        )
    fit_indices = [i for i in range(gp.n_emulators) if i not in unfit]

    means = np.full((gp.n_emulators, n_query), np.nan)
    variances = np.full((gp.n_emulators, n_query), np.nan)
    if not fit_indices:
        return means, (variances if unc else None)

    for c0, c1, padded in _super_chunks(n_query, n_dev, max_batch_size, n_train=gp.n,
                                        n_lanes=len(fit_indices)):
        t_c = _pad_rows(testing[c0:c1], padded)
        per = padded // n_dev

        def shard(k, device):
            out = []
            for rows, tiles, scale, shift in gp._predict_groups(
                t_c[k * per:(k + 1) * per], fit_indices, unc=unc,
                include_nugget=include_nugget, max_batch_size=max_batch_size, device=device,
            ):
                parts = list(tiles)
                mu = torch.cat([p[0] for p in parts], dim=-1).to("cpu", torch.float64).numpy()
                var = (torch.cat([p[1] for p in parts], dim=-1).to("cpu", torch.float64).numpy()
                       if unc else None)
                out.append((rows, mu * scale[:, None] + shift[:, None],
                            None if var is None else var * scale[:, None] ** 2))
            return out

        mu_c = np.empty((gp.n_emulators, padded))
        var_c = np.empty((gp.n_emulators, padded))
        for k, groups in enumerate(map_shards(mesh, shard)):
            for rows, mu, var in groups:
                mu_c[rows, k * per:(k + 1) * per] = mu
                if unc:
                    var_c[rows, k * per:(k + 1) * per] = var
        means[fit_indices, c0:c1] = mu_c[fit_indices, : c1 - c0]
        if unc:
            variances[fit_indices, c0:c1] = var_c[fit_indices, : c1 - c0]
    return means, (variances if unc else None)


def sharded_predict(gp, testing, mesh=None, unc=True, include_nugget=True,
                    max_batch_size=None):
    """Predict a single ``GaussianProcess`` over query points split across
    ``mesh`` (default :func:`~.mesh.auto_mesh`), in the super-chunks of
    :func:`_super_chunks`.  Returns float64 host arrays ``(mu, var)``
    (``var`` ``None`` unless ``unc``)."""
    if gp.theta.get_data() is None or gp._artifacts is None:
        raise ValueError("hyperparameters have not been fit for this Gaussian Process")
    mesh = check_mesh(mesh) or auto_mesh()
    n_dev = mesh.shape[mesh.axis_names[0]]
    testing = _testing(testing, gp.D)
    n_query = testing.shape[0]

    mu_out = np.empty((n_query,))
    var_out = np.empty((n_query,)) if unc else None
    for c0, c1, padded in _super_chunks(n_query, n_dev, max_batch_size, n_train=gp.n):
        t_c = _pad_rows(testing[c0:c1], padded)
        dm_c = gp.get_design_matrix(t_c)
        per = padded // n_dev

        def shard(k, device):
            rows = slice(k * per, (k + 1) * per)
            mu, var = gp_predict(
                to_device(gp._artifacts, device), to_device(gp._data, device),
                torch.as_tensor(t_c[rows], dtype=gp._dtype, device=device),
                torch.as_tensor(dm_c[rows], dtype=gp._dtype, device=device),
                gp.kernel, gp.nugget_type, unc=bool(unc), include_nugget=bool(include_nugget),
            )
            return (mu[0].to("cpu", torch.float64).numpy(),
                    None if var is None else var[0].to("cpu", torch.float64).numpy())

        parts = map_shards(mesh, shard)
        mu_out[c0:c1] = np.concatenate([p[0] for p in parts])[: c1 - c0]
        if unc:
            var_out[c0:c1] = np.concatenate([p[1] for p in parts])[: c1 - c0]
    if gp._standardize:
        mu_out = mu_out * gp._t_std + gp._t_mean
        if unc:
            var_out = var_out * gp._t_std**2
    return mu_out, var_out
