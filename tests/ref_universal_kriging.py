"""Plain reference of the universal-kriging emulator: mogp-emulator v0.7.2's
``GaussianProcess`` with the Matern 5/2 kernel, a linear mean with a normal
prior on its coefficients, a fitted nugget and proper priors on every
hyperparameter (``mogp_emulator/demos/gp_demos.py`` Example 3, with the
kernel of ``multioutput_tutorial.py``).

Plain PyTorch, in float64 unless the caller hands float32 tensors; TF32 is
never on here (products go through ``mm``, ``torch.matmul`` unless a caller
passes :func:`tf32_mm`, the reference one precision below float32).  It
imports neither JAX nor anything of ``mogp_tpu`` or ``mogp_tpu_torch``.

The model, for raw hyperparameters ``raw`` ``(B, D + 2)``:

* correlation lengths ``l_d = exp(-raw_d / 2)``, covariance ``sigma2 =
  exp(raw_D)``, nugget ``exp(raw_{D+1})``;
* ``K = sigma2 k(r) + nugget I``, ``k(r) = (1 + sqrt(5) r + 5 r^2 / 3)
  exp(-sqrt(5) r)``, ``r^2 = sum_d (x_d - x'_d)^2 / l_d^2``;
* the design matrix ``H = [1 | x]`` (the formula ``x[0]+...+x[D-1]``, M =
  D + 1 terms), the coefficients' prior ``N(b, B)``;
* ``A = H^T K^-1 H + B^-1``, ``beta = A^-1 (H^T K^-1 y + B^-1 b)``;
* the negative log posterior, as mogp-emulator's ``GaussianProcess.fit``
  writes it:
  ``0.5 (y^T K^-1 y + b^T B^-1 b - (H^T K^-1 y + B^-1 b)^T beta
  + log det K + log det A + log det B + n log 2 pi)`` less the log prior
  densities of ``l_d`` (``LogNormalPrior``), ``sigma2`` (``InvGammaPrior``)
  and the nugget (``GammaPrior``), each at the transformed value, with no
  Jacobian, as mogp-emulator sums them;
* prediction at ``q``: ``mu = h*^T beta + k*^T K^-1 (y - H beta)``, ``var =
  sigma2 + nugget - k*^T K^-1 k* + r^T A^-1 r`` (at least 0), ``r = h* -
  H^T K^-1 k*``; mogp-emulator adds the nugget to the variance under
  ``include_nugget=True``, its default, which ``HistoryMatching`` takes;
* the implausibility ``|z - mu| / sqrt(var + V_obs)``, the ``rank``-th
  largest over the emulators.

Departures from mogp-emulator:

* ``r^2`` is taken in the matmul form ``|z|^2 + |z'|^2 - 2 z . z'`` of the
  scaled points ``z = x / l``, and its diagonal set to an exact 0 in a
  training covariance, as the program takes it; mogp-emulator sums the
  squared differences.  In float64 the two differ by rounding alone.
* ``K`` and ``A`` are factored without jitter; a lane that does not factor
  comes out NaN instead of raising ``LinAlgError``.
* The restart points are drawn one parameter at a time, ``n_tries`` draws
  each (``restart_points``), as the program draws them; mogp-emulator's
  ``fit_GP_MAP`` draws one whole point at a time.
* ``leave_out`` removes a named part of the mean's mathematics: a fault to
  show what a comparison catches, not a model.
"""

import math

import numpy as np
import scipy.stats
import torch

LOG_2PI = math.log(2.0 * math.pi)

# Example 3's priors: LogNormalPrior(1, 1) on each correlation length,
# InvGammaPrior(1, 1) on the covariance, GammaPrior(1, 1) on the nugget,
# MeanPriors(mean=0, cov=1) on each mean coefficient (shape, scale pairs)
EXAMPLE3 = {"corr": (1.0, 1.0), "cov": (1.0, 1.0), "nugget": (1.0, 1.0), "mean": 0.0,
            "mean_cov": 1.0}

# parts of the mean's mathematics that ``leave_out`` may name
PARTS = ("logdet_A", "B_inv")


def tf32_round(t):
    """``t`` (float32) rounded to TF32, the ten-bit mantissa that the
    tensor cores read when TF32 is on (round to nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_mm(a, b):
    """A float32 product of operands rounded to TF32, accumulated in
    float32: what ``torch.backends.cuda.matmul.allow_tf32 = True`` gives."""
    return torch.matmul(tf32_round(a.to(torch.float32)), tf32_round(b.to(torch.float32)))


def prior_arrays(n_dim, spec=EXAMPLE3):
    """The priors of an emulator on ``n_dim`` inputs, as arrays:
    ``corr`` ``(D, 2)``, ``cov`` and ``nugget`` ``(2,)`` (shape, scale);
    ``mean`` ``(M,)`` and ``mean_cov`` ``(M,)``, the diagonal of ``B``."""
    M = n_dim + 1
    return {"corr": np.tile(np.asarray(spec["corr"], float), (n_dim, 1)),
            "cov": np.asarray(spec["cov"], float), "nugget": np.asarray(spec["nugget"], float),
            "mean": np.full(M, float(spec["mean"])), "mean_cov": np.full(M, float(spec["mean_cov"]))}


def design(x):
    """``H = [1 | x]`` ``(n, D + 1)``: the formula ``x[0]+...+x[D-1]``."""
    return torch.cat([torch.ones_like(x[:, :1]), x], dim=-1)


def mat52(r2):
    """``(1 + sqrt(5 r2) + 5 r2 / 3) exp(-sqrt(5 r2))``, exactly 1 at 0."""
    pos = r2 > 0.0
    safe = torch.where(pos, r2, torch.ones_like(r2))
    r = torch.sqrt(5.0 * safe)
    return torch.where(pos, (1.0 + r + (5.0 / 3.0) * safe) * torch.exp(-r), torch.ones_like(r2))


def cov(raw, x1, x2, mm=torch.matmul):
    """``sigma2 k(r)`` ``(B, m1, m2)`` without the nugget, for raw ``(B, P)``
    and points ``(m1, D)``, ``(m2, D)``; ``x2 is x1``: a training covariance,
    its diagonal distance an exact 0."""
    D = x1.shape[-1]
    s = torch.exp(0.5 * raw[:, None, :D])
    z1, z2 = x1[None] * s, x2[None] * s
    r2 = (torch.sum(z1 * z1, -1)[:, :, None] + torch.sum(z2 * z2, -1)[:, None, :]
          - 2.0 * mm(z1, z2.transpose(-1, -2)).to(raw.dtype))
    if x2 is x1:
        r2 = r2 * (1.0 - torch.eye(x1.shape[0], dtype=r2.dtype, device=r2.device))
    return torch.exp(raw[:, D])[:, None, None] * mat52(torch.clamp_min(r2, 0.0))


def _logp_lognormal(x, shape, scale):
    return -0.5 * (torch.log(x / scale) / shape) ** 2 - 0.5 * LOG_2PI - torch.log(x) - math.log(shape)


def _logp_invgamma(x, shape, scale):
    return shape * math.log(scale) - math.lgamma(shape) - (shape + 1.0) * torch.log(x) - scale / x


def _logp_gamma(x, shape, scale):
    return -shape * math.log(scale) - math.lgamma(shape) + (shape - 1.0) * torch.log(x) - x / scale


def prior_logp(raw, pr):
    """Log prior density ``(B,)`` of raw vectors ``(B, D + 2)``, written in
    the raw parametrisation: each density at ``exp(-raw_d / 2)``,
    ``exp(raw_D)`` and ``exp(raw_{D+1})``."""
    D = pr["corr"].shape[0]
    lp = sum(_logp_lognormal(torch.exp(-0.5 * raw[:, d]), *pr["corr"][d]) for d in range(D))
    lp = lp + _logp_invgamma(torch.exp(raw[:, D]), *pr["cov"])
    return lp + _logp_gamma(torch.exp(raw[:, D + 1]), *pr["nugget"])


def _chol(A):
    """Lower factors of ``(B, k, k)``; NaN where a lane does not factor."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def _logdet(L):
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)


def posterior(raw, x, y, pr, mm=torch.matmul, leave_out=()):
    """Everything a fit at raw ``(B, D + 2)`` caches, for targets ``y``
    ``(B, n)``: ``L`` and ``LA`` (the factors of ``K`` and ``A``), ``beta``,
    ``Kinv_t_mean`` (``K^-1 (y - H beta)``), ``H`` and ``nlp`` ``(B,)``."""
    unknown = set(leave_out) - set(PARTS)
    if unknown:
        raise ValueError("unknown parts {}".format(sorted(unknown)))
    n, D = x.shape
    dtype, dev = raw.dtype, raw.device
    nugget = torch.exp(raw[:, D + 1])
    K = cov(raw, x, x, mm) + nugget[:, None, None] * torch.eye(n, dtype=dtype, device=dev)
    L = _chol(K)
    H = design(x)
    HB = H.expand(raw.shape[0], *H.shape)
    KiH = torch.cholesky_solve(HB, L)
    Kiy = torch.cholesky_solve(y[..., None], L)[..., 0]
    b = torch.as_tensor(pr["mean"], dtype=dtype, device=dev)
    Binv = torch.diag(1.0 / torch.as_tensor(pr["mean_cov"], dtype=dtype, device=dev))
    if "B_inv" in leave_out:
        Binv = torch.zeros_like(Binv)
    A = mm(HB.transpose(-1, -2), KiH).to(dtype) + Binv
    LA = _chol(A)
    rhs = mm(HB.transpose(-1, -2), Kiy[..., None])[..., 0].to(dtype) + Binv @ b
    beta = torch.cholesky_solve(rhs[..., None], LA)[..., 0]
    quad = torch.sum(y * Kiy, -1) + b @ Binv @ b - torch.sum(rhs * beta, -1)
    logdet_B = torch.sum(torch.log(torch.as_tensor(pr["mean_cov"], dtype=dtype, device=dev)))
    logdet_A = 0.0 if "logdet_A" in leave_out else _logdet(LA)
    nlp = 0.5 * (quad + _logdet(L) + logdet_A + logdet_B + n * LOG_2PI) - prior_logp(raw, pr)
    resid = y - (HB @ beta[..., None])[..., 0]
    return {"L": L, "LA": LA, "beta": beta, "H": H, "nlp": nlp,
            "Kinv_t_mean": torch.cholesky_solve(resid[..., None], L)[..., 0]}


def nlp(raw, x, y, pr, mm=torch.matmul, leave_out=()):
    """The negative log posterior ``(B,)`` (:func:`posterior`)."""
    return posterior(raw, x, y, pr, mm, leave_out)["nlp"]


def predict(raw, x, y, pr, q, mm=torch.matmul, leave_out=()):
    """Predictive mean and variance ``(B, m)`` at points ``q`` ``(m, D)``,
    the nugget included in the variance."""
    post = posterior(raw, x, y, pr, mm, leave_out)
    D = x.shape[1]
    ks = cov(raw, x, q, mm)                                               # (B, n, m)
    hs = design(q).transpose(-1, -2)                                      # (M, m)
    mu = ((hs.transpose(-1, -2) @ post["beta"][..., None])[..., 0]
          + mm(ks.transpose(-1, -2), post["Kinv_t_mean"][..., None])[..., 0].to(raw.dtype))
    Kiks = torch.cholesky_solve(ks, post["L"])
    r = hs - mm(post["H"].transpose(-1, -2), Kiks).to(raw.dtype)         # (B, M, m)
    Air = torch.cholesky_solve(r, post["LA"])
    var = (torch.exp(raw[:, D])[:, None] + torch.exp(raw[:, D + 1])[:, None]
           - torch.sum(ks * Kiks, -2) + torch.sum(r * Air, -2))
    return mu, torch.clamp_min(var, 0.0)


def rank_implausibility(mu, var, obs_mean, obs_var, rank):
    """``|z - mu| / sqrt(var + V_obs)`` per emulator ``(B, m)``, then the
    ``rank``-th largest over the emulators (0: the largest): ``(m,)``."""
    I = torch.abs(obs_mean[:, None] - mu) / torch.sqrt(var + obs_var[:, None])
    return torch.sort(I, dim=0, descending=True).values[rank]


def restart_points(pr, n_emulators, n_tries, seed):
    """The restart points ``(n_emulators, n_tries, D + 2)`` drawn from the
    priors with numpy's RNG seeded with ``seed``: emulator after emulator,
    each correlation length's ``n_tries`` draws (``raw = -2 log l``), then
    the covariance's and the nugget's (``raw = log``)."""
    rs = np.random.RandomState(seed)
    D = pr["corr"].shape[0]
    out = np.empty((n_emulators, n_tries, D + 2))
    for e in range(n_emulators):
        for d in range(D):
            s, scale = pr["corr"][d]
            ell = scipy.stats.lognorm.rvs(size=n_tries, s=s, scale=scale, random_state=rs)
            out[e, :, d] = -2.0 * np.log(ell)
        a, scale = pr["cov"]
        out[e, :, D] = np.log(scipy.stats.invgamma.rvs(size=n_tries, a=a, scale=scale,
                                                      random_state=rs))
        a, scale = pr["nugget"]
        out[e, :, D + 1] = np.log(scipy.stats.gamma.rvs(size=n_tries, a=a, scale=scale,
                                                       random_state=rs))
    return out
