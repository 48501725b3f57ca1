"""Fixed-shape MICE sequential design on the device.

Port of ``mogp_tpu/uq/mice_device.py``.  Every device shape stays fixed
across the whole acquisition loop:

* The design lives in preallocated ``(n_max, D)`` buffers with a 0/1 row
  mask; masked rows of the covariance become unit diagonal rows (``K~ = m
  m^T * K + diag(1 - m)``), whose Cholesky factor carries them as exact
  unit pivots, and the adaptive jitter is restricted to the observed rows
  (``ops/cholesky.py``'s ``jitter_mask``).  So :func:`masked_gp_nlp`
  equals ``gp_nlp`` on the observed sub-design.
* The per-step MAP refit (:func:`_mice_fit_step`) is one batched L-BFGS
  over a lanes axis of restarts on the masked objective: K2 factors the
  ``(restarts, n_max, n_max)`` covariances of every evaluation.
* The scoring (:func:`_mice_score_step`) takes the candidate blocks as
  lanes: the base GP's mean and variance at every candidate through the
  fused prediction (on the observed rows only: the masked rows sit at the
  end of the buffer, so the leading ``(n_obs, n_obs)`` block of the masked
  factor is the observed sub-design's factor), and each block's
  leave-one-out candidate variance from its masked covariance, factored
  through the jitter ladder (one launch of the blocked route a rung above
  K2's bound, n > 340 in float32), and one lower solve of the identity
  (``sequential_design.py::_loo_variances_all``: the function of
  ``mogp_tpu``'s Woodbury sum over ``L^-1 [C | I]``, which in float32
  cancels away every digit at these nuggets).  With ``cand_block <
  n_cand`` a candidate's variance conditions on its own block only, the
  JAX package's block-local approximation.

With ``mesh=`` (a ``parallel.DeviceMesh``) the candidate blocks are split
over its devices (``mogp_tpu/uq/mice_device.py:224-250``): the block count
is padded to a multiple of the mesh with fully masked blocks, every device
scores its consecutive blocks against the design on its own copy, and the
argmax over the gathered scores is the unsharded one.  The refit stays on
the design's device.
"""

import numpy as np
import torch

from ..models.fitting import _DEFAULT_LADDER, _LADDER_MODES
from ..models.gp import FitArtifacts, _matvec, _prior_logp, gp_predict, make_gp_data, take_lanes
from ..models.priors import GPPriors
from ..ops.cholesky import ChoFactor, cholesky_factor, jit_cholesky
from ..ops.kernels import get_kernel
from ..ops.lbfgs import lbfgs_minimize
from ..ops.linalg import marginal_core, marginal_nlp
from ..parallel.mesh import check_mesh, map_shards, to_device
from .sequential_design import MICEDesign, _loo_variances_all

__all__ = ["DeviceMICEDesign", "masked_gp_nlp"]

# the trajectory ladder of the per-step refit ("single"), as fit_GP_MAP's
_OPT_LADDER = _LADDER_MODES[_DEFAULT_LADDER]

# Candidate blocks scored at once: their (B, B) working set -- the
# covariance, the ladder's candidates and factors, the identity and its
# solve, about _BLOCK_MATRICES matrices a block -- is kept under
# _SCORE_CHUNK_BYTES, so that the 25 blocks of 4096 of a 10^5-candidate
# design are one batch in float32 on an 80 GB card.
_SCORE_CHUNK_BYTES = 24 * 2**30
_BLOCK_MATRICES = 12


def _nugget_of(raw, data, n_corr, nugget_type):
    """The nugget ``(L,)`` before factorization: ``exp`` of the last raw
    entry for ``"fit"``, the data's for ``"fixed"``, else zero."""
    if nugget_type == "fit":
        return torch.exp(raw[:, -1])
    if nugget_type == "fixed":
        return data.fixed_nugget.expand(raw.shape[0])
    return torch.zeros_like(raw[:, n_corr])


def _masked_cov(K, mask):
    """``m m^T * K + diag(1 - m)`` for ``K`` ``(..., n, n)`` and a 0/1
    ``mask`` ``(..., n)``."""
    return (mask[..., :, None] * mask[..., None, :]) * K + torch.diag_embed(1.0 - mask)


def masked_gp_nlp(raw, data, mask, kernel, nugget_type, weak_mean=True,
                  sparse_ladder=False):
    """Negative log posterior ``(L,)`` of the masked fixed-shape design for
    raw hyperparameters ``(L, P)``.

    Equals ``gp_nlp`` on the observed sub-design (rows with ``mask == 1``):
    masked rows enter the covariance as exact unit pivots and their targets
    and design rows are zeroed, and the ``n log 2 pi`` normalization counts
    the observed rows.  Differentiable by autograd in ``raw``.

    :param data: a ``GPData`` of one lane or of ``L``.
    :param mask: ``(n_max,)`` or ``(L, n_max)`` 0/1.
    """
    n_corr = kernel.get_n_params(data.inputs)
    sigma2 = torch.exp(raw[:, n_corr])
    mask = mask.to(data.inputs.dtype)
    nugget = _nugget_of(raw, data, n_corr, nugget_type)

    K = sigma2[:, None, None] * kernel.kernel_f(data.inputs, data.inputs, raw[:, :n_corr])
    Kinv, _ = cholesky_factor(
        _masked_cov(K, mask), nugget, nugget_type, sparse_ladder=sparse_ladder,
        jitter_mask=mask, progressive_ok=False,
    )
    resid = mask * (data.targets - _matvec(data.dm, data.mean_mean))
    core = marginal_core(Kinv, mask[..., :, None] * data.dm, resid, data.mean_inv_cov)

    n_obs = torch.sum(mask, dim=-1)
    n_coeff = n_obs - data.dm.shape[-1] if weak_mean else n_obs
    nlp = marginal_nlp(core, Kinv, data.mean_logdet_cov, n_coeff)
    return nlp - _prior_logp(data, raw, n_corr, nugget_type)


def _mice_fit_step(starts, data, mask, kernel, nugget_type, weak_mean, maxiter, gtol, ftol,
                   ladder):
    """Every MAP restart ``(T, P)`` of the masked GP as a lane of one
    batched L-BFGS; returns ``(fun (T,), x (T, P))``.  Its shapes do not
    depend on the step."""
    lanes = take_lanes(data, torch.zeros(starts.shape[0], dtype=torch.int64,
                                         device=starts.device))
    res = lbfgs_minimize(
        lambda raw: masked_gp_nlp(raw, lanes, mask, kernel, nugget_type, weak_mean,
                                  sparse_ladder=ladder),
        starts, maxiter=maxiter, gtol=gtol, ftol=ftol,
    )
    return res.fun, res.x


def _observed_count(mask):
    """The number of observed rows of a prefix mask (ones, then zeros);
    raises ``ValueError`` for any other mask."""
    m = mask.to("cpu", torch.float64)
    n_obs = int(m.sum())
    if not (torch.all(m[:n_obs] == 1.0) and torch.all(m[n_obs:] == 0.0)):
        raise ValueError("the design mask must mark a prefix of the buffer: its observed "
                         "rows first, then the masked ones")
    return n_obs


def _base_predict(kernel, data, raw, L_obs, alpha, nugget, cands):
    """The base GP's mean and variance ``(1, m)`` at ``cands`` ``(m, D)``
    from its ``n_obs`` observed rows alone (``L_obs`` ``(1, n_obs,
    n_obs)``, ``alpha = K^-1 y`` on them; zero mean): ``gp_predict`` on the
    sub-design, so the fused prediction where its route takes the kernel."""
    n_obs = L_obs.shape[-1]
    none = alpha.new_zeros
    arts = FitArtifacts(raw=raw, Kinv=ChoFactor(L_obs), Ainv=ChoFactor(none((1, 0, 0))),
                        mean=none((1, 0)), Kinv_t_mean=alpha, Kinv_dm=none((1, n_obs, 0)),
                        nugget=nugget, logpost=torch.zeros_like(nugget))
    sub = data._replace(inputs=data.inputs[:, :n_obs], dm=data.dm[:, :n_obs])
    return gp_predict(arts, sub, cands, none((cands.shape[0], 0)), kernel, "fixed")


def _cand_cov(kernel, cand, cmask, corr_raw, sigma2):
    """The masked candidate covariances ``(b, B, B)`` of blocks ``cand``
    ``(b, B, D)``: one ``kernel_f_predict`` a block (K1 for the stationary
    and uniform forms: direct differences, so the diagonal's r2 is exactly
    0)."""
    K = torch.empty(cand.shape[:2] + cand.shape[1:2], dtype=cand.dtype, device=cand.device)
    for i, c in enumerate(cand):
        K[i] = kernel.kernel_f_predict(c, c, corr_raw, sigma2)[0]
    return _masked_cov(K, cmask)


def _score_chunk(B, dtype):
    """Candidate blocks scored at once (``_SCORE_CHUNK_BYTES``)."""
    item = torch.finfo(dtype).bits // 8
    return max(1, _SCORE_CHUNK_BYTES // (_BLOCK_MATRICES * B * B * item))


@torch.no_grad()
def _mice_score_step(raw, data, mask, cand_blocks, cand_mask, fast_nugget, nugget_s, kernel,
                     nugget_type, weak_mean):
    """MICE criterion ``unc_base / unc_cand`` and the base GP's mean at
    every candidate.

    :param raw: ``(P,)`` raw hyperparameters of the step's fit.
    :param data: one-lane ``GPData`` of the ``(n_max, D)`` buffers (zero
        mean: ``M = 0``).
    :param mask: ``(n_max,)`` 0/1, the observed rows first.
    :param cand_blocks: ``(n_blocks, B, D)`` padded candidate blocks.
    :param cand_mask: ``(n_blocks, B)`` 0/1; padded candidates enter their
        block's covariance as unit pivots, so they do not touch the real
        candidates' leave-one-out variances.
    :param fast_nugget: the candidate GP's nugget floor (a float).
    :param nugget_s: the smoothing multiplier: the candidate GP's nugget is
        ``max(realized nugget * nugget_s, fast_nugget)``, the realized
        nugget being the base factorization's (its adaptive jitter).
    :returns: ``(scores, mu)``, each ``(n_blocks * B,)``.
    """
    raw = raw.reshape(1, -1)
    n_corr = kernel.get_n_params(data.inputs)
    corr_raw = raw[:, :n_corr]
    sigma2 = torch.exp(raw[:, n_corr])
    dtype = data.inputs.dtype
    mask = mask.to(dtype)
    n_obs = _observed_count(mask)

    # the reference jitter ladder for the realized fit (the optimizer's
    # trajectory may have used the one-rung ladder)
    K = sigma2[:, None, None] * kernel.kernel_f(data.inputs, data.inputs, corr_raw)
    Kinv, nugget = cholesky_factor(_masked_cov(K, mask), _nugget_of(raw, data, n_corr, nugget_type),
                                   nugget_type, jitter_mask=mask)
    fast_nugget = torch.clamp_min(nugget * nugget_s, fast_nugget)

    # the observed sub-design: the leading block of the masked factor, the
    # zero-mean GP's K^-1 y on it, and sigma2 plus the realized nugget
    L_obs = Kinv.L[:, :n_obs, :n_obs]
    alpha = ChoFactor(L_obs).solve(data.targets[:, :n_obs])
    n_blocks, B, D = cand_blocks.shape
    mu, unc1 = _base_predict(kernel, data, raw, L_obs, alpha, nugget, cand_blocks.reshape(-1, D))
    unc1 = unc1.reshape(n_blocks, B)

    # each block's candidate GP: its covariance factors through the
    # adaptive ladder on top of the smoothing nugget (the jitter on the real
    # candidates only), and the leave-one-out variances come from one lower
    # solve of the identity, less the rung's jitter (_loo_variances_all)
    eye = torch.eye(B, dtype=dtype, device=cand_blocks.device)
    unc2 = []
    chunk = _score_chunk(B, dtype)
    for c0 in range(0, n_blocks, chunk):
        cand, cmask = cand_blocks[c0:c0 + chunk], cand_mask[c0:c0 + chunk].to(dtype)
        C = _cand_cov(kernel, cand, cmask, corr_raw, sigma2)
        Lq, jitter = jit_cholesky(C + fast_nugget * torch.diag_embed(cmask), jitter_mask=cmask)
        del C
        V = Lq.solve_L(eye.expand_as(Lq.L))
        del Lq
        unc2.append(_loo_variances_all(V, jitter[:, None]))
        del V
    scores = unc1 / torch.clamp_min(torch.cat(unc2), torch.finfo(dtype).tiny)
    return scores.reshape(-1), mu.reshape(-1)


class DeviceMICEDesign(MICEDesign):
    """MICE design whose acquisition loop keeps every device shape fixed
    (module doc); ``mogp_tpu/uq/mice_device.py:253-504``.

    Drop-in for :class:`MICEDesign` (the same state machine, save / load
    and batch points), with these differences:

    * ``n_samples`` (or an explicit ``n_max``) must be known up front to
      size the design buffers; a design grown past ``n_max`` raises.
    * ``cand_block`` is the candidate GP's block size (default: dense up
      to 4096 candidates, blocks of 4096 beyond, the block-local
      approximation).
    * The per-step refit is the batched-restart L-BFGS of ``fit_GP_MAP``
      (``n_tries`` / ``maxiter``) on the masked objective; a draw whose
      every restart failed draws again, and under ``nugget="adaptive"``
      the fourth and later draws use the full jitter ladder.
    * ``nugget="pivot"`` raises (the pivoted factorization has no masked
      form).
    * ``mesh`` splits the scoring's candidate blocks over its devices
      (module doc).
    * :meth:`_estimate_next_target` takes only the point the last step
      chose, whose mean the score step computed.
    """

    def __init__(self, base_design, f=None, n_samples=None, n_init=10,
                 n_cand=50, nugget="adaptive", nugget_s=1.0, n_max=None,
                 n_tries=15, maxiter=200, cand_block=None,
                 kernel="SquaredExponential", mesh=None, device=None, dtype=None):
        self.mesh = check_mesh(mesh)
        super().__init__(base_design, f, n_samples, n_init, n_cand, nugget, nugget_s,
                         device, dtype)
        if nugget == "pivot":
            raise ValueError(
                "DeviceMICEDesign does not support nugget='pivot' (the masked "
                "fixed-shape covariance requires a jitter-masked factorization; "
                "pivoted Cholesky has no masked form) -- use MICEDesign for "
                "pivot-nugget designs"
            )
        self._kernel = get_kernel(kernel)
        if n_max is None:
            if n_samples is None:
                raise ValueError(
                    "DeviceMICEDesign needs n_samples or n_max to preallocate the "
                    "fixed-shape design buffers"
                )
            n_max = int(n_init) + int(n_samples)
        self.n_max = int(n_max)
        self.n_tries = int(n_tries)
        self.maxiter = int(maxiter)
        if cand_block is None:
            cand_block = min(self.n_cand, 4096)
        self.cand_block = int(cand_block)
        n_blocks = -(-self.n_cand // self.cand_block)
        if mesh is not None:
            n_dev = mesh.shape[mesh.axis_names[0]]
            n_blocks = -(-n_blocks // n_dev) * n_dev
        self._n_cand_pad = n_blocks * self.cand_block
        self._last_scores = None
        self._last_mu = None
        self._theta = None

    def get_current_theta(self):
        """Raw hyperparameters of the most recent per-step refit."""
        return self._theta

    def _nugget_type_and_value(self):
        if isinstance(self.nugget, str):
            return self.nugget, 0.0
        return "fixed", float(self.nugget)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _fit(self, data, mask, priors, nugget_type):
        """The step's MAP refit; returns the best restart's raw
        hyperparameters (float64 numpy)."""
        for attempt in range(10):
            starts = self._tensor(priors.sample_n(self.n_tries))
            ladder = False if (attempt >= 3 and nugget_type == "adaptive") else _OPT_LADDER
            fun, xs = _mice_fit_step(starts, data, mask, self._kernel, nugget_type, True,
                                     self.maxiter, None, None, ladder)
            fun = fun.to("cpu", torch.float64).numpy()
            finite = np.isfinite(fun)
            if finite.any():
                return xs.to("cpu", torch.float64).numpy()[
                    int(np.nanargmin(np.where(finite, fun, np.inf)))]
        raise RuntimeError("Unable to find parameters suitable for both GPs")

    def _eval_metric(self):
        """The fixed-shape acquisition step: refit, then score."""
        n_obs = self.inputs.shape[0]
        if n_obs > self.n_max:
            raise RuntimeError(
                "design grew past the preallocated n_max={} buffers; construct "
                "DeviceMICEDesign with a larger n_max".format(self.n_max)
            )
        D = self.get_n_parameters()

        # standardized targets (see MICEDesign._eval_metric)
        self._t_mean = float(np.mean(self.targets))
        self._t_std = float(np.std(self.targets)) or 1.0
        targets_std = (self.targets - self._t_mean) / self._t_std

        # the buffers: masked rows repeat the first point (any finite value
        # works; the mask decouples them exactly)
        inputs_buf = np.tile(self.inputs[:1], (self.n_max, 1))
        inputs_buf[:n_obs] = self.inputs
        targets_buf = np.zeros(self.n_max)
        targets_buf[:n_obs] = targets_std
        mask = np.zeros(self.n_max)
        mask[:n_obs] = 1.0

        nugget_type, nugget_value = self._nugget_type_and_value()
        # data-driven priors from the observed design; the correlation slots
        # are the kernel's (one for the uniform forms)
        priors = GPPriors.default_priors(
            self.inputs, self._kernel.get_n_params(self.inputs), nugget_type=nugget_type,
        )
        data = make_gp_data(inputs_buf, targets_buf, np.zeros((self.n_max, 0)), priors,
                            nugget_value=nugget_value, dtype=self.dtype, device=self.device)
        mask_t = self._tensor(mask)

        best_raw = self._fit(data, mask_t, priors, nugget_type)
        self._theta = best_raw

        # candidate blocks padded to a block multiple; the padded
        # candidates are masked out of their block's covariance
        cands = np.tile(self.candidates[:1], (self._n_cand_pad, 1))
        cands[: self.n_cand] = self.candidates
        cmask = np.zeros(self._n_cand_pad)
        cmask[: self.n_cand] = 1.0

        # the candidate GP's nugget floor, as in MICEDesign._eval_metric;
        # under "adaptive" the realized jitter enters inside the score step
        if nugget_type == "adaptive":
            base_nugget = 0.0
        elif nugget_type == "fit":
            base_nugget = float(np.exp(best_raw[-1]))
        else:
            base_nugget = nugget_value
        sigma2 = float(np.exp(best_raw[self._kernel.get_n_params(self.inputs)]))
        eps = float(torch.finfo(self.dtype).eps)
        fast_nugget = max(base_nugget * self.nugget_s, 1e3 * eps * sigma2)

        cand_blocks = cands.reshape(-1, self.cand_block, D)
        cand_mask = cmask.reshape(-1, self.cand_block)

        def score(blocks, device):
            return [x.to("cpu", torch.float64).numpy() for x in _mice_score_step(
                torch.as_tensor(best_raw, dtype=self.dtype, device=device),
                to_device(data, device), mask_t.to(device),
                torch.as_tensor(cand_blocks[blocks], dtype=self.dtype, device=device),
                torch.as_tensor(cand_mask[blocks], dtype=self.dtype, device=device),
                fast_nugget, self.nugget_s, self._kernel, nugget_type, True,
            )]

        if self.mesh is None:
            scores, mu = score(slice(None), self.device)
        else:
            per = cand_blocks.shape[0] // self.mesh.shape[self.mesh.axis_names[0]]
            shards = map_shards(self.mesh, lambda k, d: score(slice(k * per, (k + 1) * per), d))
            scores, mu = (np.concatenate(x) for x in zip(*shards))
        scores = scores[: self.n_cand]
        mu = mu[: self.n_cand]
        scores = np.where(np.isfinite(scores), scores, -np.inf)
        if not np.any(np.isfinite(scores)):
            raise RuntimeError("Unable to find parameters suitable for both GPs")
        self._last_scores = scores
        self._last_mu = mu
        self._last_index = int(np.argmax(scores))
        return self._last_index

    def _MICE_criterion(self, data_point):
        """Per-candidate criterion from the last acquisition step."""
        data_point = int(data_point)
        assert 0 <= data_point < self.n_cand, "test point index is out of range"
        assert self._last_scores is not None, "no acquisition step has run"
        return float(self._last_scores[data_point])

    def _estimate_next_target(self, next_point):
        """The base GP's mean at the point the last step chose, computed by
        the score step; any other point raises ``ValueError`` (a narrowing
        of the base class, which predicts anywhere)."""
        next_point = np.array(next_point)
        assert next_point.shape == (self.get_n_parameters(),), (
            "bad shape for next_point"
        )
        assert self._last_mu is not None, "no acquisition step has run"
        if not np.allclose(next_point, self.candidates[self._last_index], rtol=1e-6,
                           atol=1e-8):
            raise ValueError(
                "DeviceMICEDesign._estimate_next_target only supports the candidate "
                "selected by the last get_next_point (the cached predictive mean "
                "belongs to that point); use MICEDesign for arbitrary-point estimates"
            )
        return np.atleast_1d(self._last_mu[self._last_index] * self._t_std + self._t_mean)
