"""The work of a sweep whose emulators carry a mean function and the
Matern 5/2 kernel, counted from the cell's shapes.  ``work.py``'s
``predict_flops`` counts a zero-mean squared-exponential emulator and none
of this work.

A count is of what the algorithm needs, not of what a kernel happens to
do (``work.py``).
"""

# operations of the Matern 5/2 base on one scaled squared distance r2, and
# its scale: 5 r2 (1), its square root r (1), 5 r2 / 3 (1), the two
# additions of 1 + r + 5 r2 / 3 (2), exp(-r) (1), the product (1), sigma2
# (1)
MAT52_OPS = 8


def predict_flops_mean(n, D, M, outputs):
    """Floating-point operations of one query point's prediction and
    implausibility over every output of Matern 5/2 emulators trained on
    ``n`` points in ``D`` inputs, with ``M`` mean terms, per output:

    * ``n (3D + MAT52_OPS)`` for the cross-covariance ``k*`` (the scaled
      difference, its square and sum in each input, then the Matern base
      and the scale);
    * ``n^2`` for the substitution ``L^-1 k*``;
    * ``2nM + 3M`` for the mean terms: ``h*^T beta`` (``2M``) and ``r = h* -
      Kinv_dm^T k*`` (``2nM + M``);
    * ``M^2`` for the substitution ``LA^-1 r``;
    * ``4n + 2M`` for the norms: ``k*^T alpha`` and ``|L^-1 k*|^2`` (``2n``
      each), ``|LA^-1 r|^2`` (``2M``).
    """
    return outputs * (n * (3 * D + MAT52_OPS) + n * n + 2 * n * M + 3 * M + M * M
                      + 4 * n + 2 * M)


def mean_terms(config):
    """M, the columns of the design matrix that the configuration's ``mean``
    formula makes over its inputs, as the program counts them; 0 for
    ``"zero"`` or none."""
    from mogp_tpu_torch.models.meanfun import n_mean_params

    mean = config["model"].get("mean", "zero")
    return 0 if mean == "zero" else n_mean_params(mean, config["data"]["n_dim"])
