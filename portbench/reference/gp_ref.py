"""Plain reference of the emulators the benchmark's cells run, and the
default reference module of a configuration (the interface that the
harness calls is described in ``pbcore/cells.py``; its functions are the
last section here).

A squared-exponential Gaussian process with zero mean, per-input
correlation lengths ``l_d = exp(-raw_d / 2)``, covariance ``sigma2 =
exp(raw_D)`` and mogp-emulator's default priors: an inverse-gamma prior on
each correlation length with 99% of its mass between the input's median
spacing and its range (the mode-anchored form where that solve fails), a
weak prior on the covariance.  Under ``nugget="adaptive"`` the nugget is the
first rung of ``mean(diag K) * [0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2]`` at which
``K`` factors.

Plain PyTorch and NumPy, in float64 unless told otherwise.  It imports
nothing of the program and takes nothing the program made: it builds the
priors, ``K``, the ladder and the factors again from the inputs the
benchmark handed the program.  The program's outputs (the fitted ``raw``,
the nugget it chose, its log posterior, its implausibilities) are only
judged here.

``mm`` is the matrix product every routine uses where the program's kernel
would multiply matrices: ``torch.matmul`` for the reference, :func:`tf32_mm`
for the control, which is the reference in the next precision below
float32.
"""

import math

import numpy as np
import scipy.stats
import torch
from scipy.optimize import minimize, root

# the adaptive nugget's rungs, as multiples of mean(diag K)
LADDER = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
# how close a nugget must lie to a rung of the reference's own ladder: the
# program's mean(diag K) = sigma2 is rounded to its float32 once or twice
RUNG_RTOL = 1e-4


def tf32_round(t):
    """``t`` (float32) rounded to TF32, the ten-bit mantissa that the
    tensor cores read when TF32 is on (round to nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_mm(a, b):
    """A float32 product of operands rounded to TF32, accumulated in
    float32: what ``torch.backends.cuda.matmul.allow_tf32 = True`` gives."""
    return torch.matmul(tf32_round(a.to(torch.float32)), tf32_round(b.to(torch.float32)))


# ---------------------------------------------------------------------------
# default priors (mogp-emulator's Priors.default_priors, invgamma)
# ---------------------------------------------------------------------------

def _median_spacing(v):
    u = np.unique(v)
    return 0.0 if len(u) <= 2 else float(np.median(np.diff(np.sort(u))))


def _value_range(v):
    u = np.unique(v)
    return 0.0 if len(u) <= 1 else float(u.max() - u.min())


def _invgamma_mass(lo, hi):
    """(shape, scale) with 0.5% of the mass below ``lo`` and 99.5% below
    ``hi``, or ``None`` where the solve fails."""
    def f(x):
        cdf = scipy.stats.invgamma(np.exp(x[0]), scale=np.exp(x[1])).cdf
        return np.array([cdf(lo) - 0.005, cdf(hi) - 0.995])

    res = root(f, np.zeros(2))
    return (float(np.exp(res["x"][0])), float(np.exp(res["x"][1]))) if res["success"] else None


def _invgamma_mode(lo, hi):
    """(shape, scale) with its mode at ``sqrt(lo hi)`` and 99.5% of the mass
    below ``hi``, or ``None``."""
    mode = math.sqrt(lo * hi)

    def f(x):
        a = np.exp(x)
        return scipy.stats.invgamma(a, scale=(1.0 + a) * mode).cdf(hi) - 0.995

    res = root(f, 0.0)
    if not res["success"]:
        return None
    a = float(np.exp(res["x"][0]))
    return (a, (1.0 + a) * mode)


def default_corr_priors(inputs):
    """``(D, 2)`` inverse-gamma (shape, scale) of each correlation length's
    default prior; a row of NaN is a weak prior."""
    out = np.full((inputs.shape[1], 2), np.nan)
    for d, col in enumerate(np.asarray(inputs, dtype=np.float64).T):
        lo, hi = _median_spacing(col), _value_range(col)
        if lo > 0.0 and hi > 0.0:
            p = _invgamma_mass(lo, hi) or _invgamma_mode(lo, hi)
            if p is not None:
                out[d] = p
    return out


def restart_points(priors, n_emulators, n_tries, seed):
    """The restart points ``(n_emulators, n_tries, D + 1)`` that
    mogp-emulator's ``fit_GP_MAP`` draws from the default priors with numpy's
    RNG seeded with ``seed``: emulator after emulator, each correlation
    length's ``n_tries`` draws (inverse gamma, ``raw = -2 log l``; a weak
    prior uniform on [-2.5, 2.5] raw), then the covariance's (weak)."""
    rs = np.random.RandomState(seed)
    D = priors.shape[0]
    out = np.empty((n_emulators, n_tries, D + 1))
    for e in range(n_emulators):
        for d in range(D):
            a, b = priors[d]
            if np.isfinite(a):
                ell = scipy.stats.invgamma.rvs(size=n_tries, a=a, scale=b, random_state=rs)
                out[e, :, d] = -2.0 * np.log(ell)
            else:
                out[e, :, d] = 5.0 * (rs.rand(n_tries) - 0.5)
        out[e, :, D] = 5.0 * (rs.rand(n_tries) - 0.5)
    return out


def prior_logp(raw, priors):
    """Log prior density of raw vectors ``(B, D + 1)``: the inverse-gamma
    density of each correlation length (weak rows add 0)."""
    D = priors.shape[0]
    a = torch.as_tensor(priors[:, 0], dtype=raw.dtype, device=raw.device)
    b = torch.as_tensor(priors[:, 1], dtype=raw.dtype, device=raw.device)
    ell = torch.exp(-0.5 * raw[:, :D])
    lp = a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(ell) - b / ell
    return torch.sum(torch.where(torch.isfinite(a), lp, torch.zeros_like(lp)), dim=-1)


# ---------------------------------------------------------------------------
# covariance, log posterior, prediction
# ---------------------------------------------------------------------------

def cov(raw, x1, x2, mm=torch.matmul):
    """``sigma2 exp(-r^2 / 2)`` ``(B, m1, m2)`` for raw ``(B, D + 1)`` and
    points ``(m1, D)``, ``(m2, D)``; ``r^2`` in the matmul form
    ``|z1|^2 + |z2|^2 - 2 z1 z2^T`` of the scaled points ``z = x exp(raw/2)``."""
    D = x1.shape[-1]
    s = torch.exp(0.5 * raw[:, None, :D])
    z1, z2 = x1[None] * s, x2[None] * s
    r2 = (torch.sum(z1 * z1, -1)[:, :, None] + torch.sum(z2 * z2, -1)[:, None, :]
          - 2.0 * mm(z1, z2.transpose(-1, -2)).to(raw.dtype))
    return torch.exp(raw[:, D])[:, None, None] * torch.exp(-0.5 * torch.clamp_min(r2, 0.0))


def rung_of(nugget, mean_diag):
    """Index of the ladder rung that ``nugget`` is for a matrix of mean
    diagonal ``mean_diag``, or -1 where it is none of them."""
    for k, f in enumerate(LADDER):
        if (nugget == 0.0 if f == 0.0
                else abs(nugget - f * mean_diag) <= RUNG_RTOL * f * mean_diag):
            return k
    return -1


def factor(raw, x, rungs, mm=torch.matmul):
    """Cholesky factors of ``K + rung * mean(diag K) I`` ``(B, n, n)`` for
    each lane's rung index; NaN where a lane does not factor."""
    K = cov(raw, x, x, mm)
    mean_diag = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1).detach()
    f = torch.as_tensor([LADDER[r] for r in rungs], dtype=K.dtype, device=K.device)
    K = K + (f * mean_diag)[:, None, None] * torch.eye(x.shape[0], dtype=K.dtype,
                                                      device=K.device)
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def nlp(raw, x, y, priors, rungs, mm=torch.matmul):
    """Negative log posterior ``(B,)`` at raw ``(B, D + 1)``, targets ``y``
    ``(B, n)``, each lane at its rung (zero mean, so no mean term)."""
    n = x.shape[0]
    L = factor(raw, x, rungs, mm)
    alpha = torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
    data = 0.5 * (torch.sum(alpha * alpha, -1) + logdet + n * math.log(2.0 * math.pi))
    return data - prior_logp(raw, priors)


def adaptive(raw, x, y, priors, mm=torch.matmul):
    """The adaptive nugget worked out in the precision of ``raw``: each
    lane's first rung at which ``K`` factors, and its negative log
    posterior there (-1 and NaN where no rung factors)."""
    rungs = [-1] * raw.shape[0]
    out = torch.full((raw.shape[0],), float("nan"), dtype=raw.dtype, device=raw.device)
    for k in range(len(LADDER)):
        todo = [i for i, r in enumerate(rungs) if r < 0]
        if not todo:
            break
        v = nlp(raw[todo], x, y[todo], priors, [k] * len(todo), mm)
        for j, i in enumerate(todo):
            if torch.isfinite(v[j]):
                rungs[i], out[i] = k, v[j]
    return rungs, out


def mean_diag(raw, x):
    """``mean(diag K)`` ``(B,)``: ``sigma2`` up to the rounding of ``r^2``."""
    return torch.diagonal(cov(raw, x, x), dim1=-2, dim2=-1).mean(-1)


def predict(raw, x, y, rungs, q, mm=torch.matmul):
    """Predictive mean and variance ``(B, m)`` at points ``q`` ``(m, D)``:
    ``k*^T K^-1 y`` and ``sigma2 + nugget - |L^-1 k*|^2`` (at least 0)."""
    L = factor(raw, x, rungs, mm)
    Kd = torch.diagonal(cov(raw, x, x, mm), dim1=-2, dim2=-1).mean(-1)
    nug = torch.as_tensor([LADDER[r] for r in rungs], dtype=L.dtype, device=L.device) * Kd
    ks = cov(raw, x, q, mm)                                        # (B, n, m)
    v = torch.linalg.solve_triangular(L, ks, upper=False)          # L^-1 k*
    alpha = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    mu = mm(v.transpose(-1, -2), alpha)[..., 0].to(L.dtype)
    var = torch.exp(raw[:, -1])[:, None] + nug[:, None] - torch.sum(v * v, dim=-2)
    return mu, torch.clamp_min(var, 0.0)


def rank_implausibility(mu, var, obs_mean, obs_var, rank):
    """``|z - mu| / sqrt(var + V_obs)`` per output ``(G, m)``, then the
    ``rank``-th largest over the outputs (0: the largest): ``(m,)``."""
    I = torch.abs(obs_mean[:, None] - mu) / torch.sqrt(var + obs_var[:, None])
    return torch.sort(I, dim=0, descending=True).values[rank]


def polish_rung(raw0, x, y, priors, rung, maxiter=30):
    """Minimize the reference's negative log posterior of one emulator from
    ``raw0`` by L-BFGS-B in float64 (the nugget at the same rung of each
    point's own ladder, held constant in the gradient as the program holds
    its jitter).  Returns ``(nlp at raw0, the least nlp found)``."""
    dev = x.device

    def f(r):
        t = torch.tensor(r[None], dtype=torch.float64, device=dev, requires_grad=True)
        v = nlp(t, x, y[None], priors, [rung])[0]
        if not torch.isfinite(v):
            return np.inf, np.zeros_like(r)
        (g,) = torch.autograd.grad(v, t)
        return float(v.detach()), g[0].cpu().numpy()

    start, _ = f(np.asarray(raw0, dtype=np.float64))
    res = minimize(f, np.asarray(raw0, dtype=np.float64), jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter})
    return start, min(start, float(res.fun))


# ---------------------------------------------------------------------------
# the interface that the harness calls (``pbcore/cells.py``): numpy in and
# out, the program's nuggets as it reports them, turned into rungs here
# ---------------------------------------------------------------------------

def _tensors(device, dtype, *arrays):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _rungs(raw, x, nugget):
    """Each lane's rung for the nugget ``nugget`` at raw (tensors), -1
    where it is none."""
    md = mean_diag(raw.double(), x.double()).cpu().numpy()
    return [rung_of(g, m) for g, m in zip(nugget, md)]


def priors(x):
    """The default priors of the inputs ``x``: :func:`default_corr_priors`."""
    return default_corr_priors(x)


def seeded_raw(n_outputs, n_dim, seed):
    """Raw hyperparameters ``(n_outputs, n_dim + 1)`` drawn from ``seed``:
    correlation raws in U(-1, 1), covariance raw in U(-0.5, 0.5) (a copy of
    ``chip_smoke.py::make_thetas``)."""
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(-1, 1, size=(n_outputs, n_dim)),
         rng.uniform(-0.5, 0.5, size=(n_outputs, 1))],
        axis=1,
    )


def judge(raw, nugget, x, y, priors, device):
    """The program's emulators ``(B,)`` at their hyperparameters ``raw`` and
    nuggets: whether each nugget is a rung of this model's own ladder, and
    the negative log posterior in float64 there (NaN where it is not)."""
    raw_t, X = _tensors(device, torch.float64, raw, x)
    rungs = np.asarray(_rungs(raw_t, X, nugget))
    on = rungs >= 0
    out = np.full(len(rungs), np.nan)
    if on.any():
        (Y,) = _tensors(device, torch.float64, y[on])
        out[on] = nlp(raw_t[torch.as_tensor(on, device=device)], X, Y, priors,
                      rungs[on].tolist()).cpu().numpy()
    return on, out


def own_fit(raw, x, y, priors, device, tf32=False):
    """This model's own nugget at raw ``(B, D + 1)``, the first rung that
    factors, and the negative log posterior there, in float64 or, where
    ``tf32``, in float32 with TF32 products (the control); NaN where no rung
    factors."""
    dtype, mm = (torch.float32, tf32_mm) if tf32 else (torch.float64, torch.matmul)
    raw_t, X, Y = _tensors(device, dtype, raw, x, y)
    rungs, v = adaptive(raw_t, X, Y, priors, mm=mm)
    md = mean_diag(raw_t.double(), X.double()).cpu().numpy()
    nug = np.array([LADDER[k] * m if k >= 0 else np.nan for k, m in zip(rungs, md)])
    return nug, v.double().cpu().numpy()


def polish(raw0, nugget, x, y, priors, device):
    """:func:`polish_rung` of one emulator from the program's ``raw0`` and
    nugget: ``(nlp at raw0, the least nlp found)``."""
    raw_t, X, Y = _tensors(device, torch.float64, raw0[None], x, y)
    (rung,) = _rungs(raw_t, X, [nugget])
    return polish_rung(raw0, X, Y, priors, rung)


def implausibility(raw, nugget, x, y, q, obs_mean, obs_var, rank, device, tf32=False):
    """The ``rank``-th largest implausibility over the emulators ``(m,)`` at
    points ``q`` ``(m, D)``, from their prediction at raw and nuggets, in
    float64 or, where ``tf32``, in float32 with TF32 products."""
    dtype, mm = (torch.float32, tf32_mm) if tf32 else (torch.float64, torch.matmul)
    raw_t, X, Y, Q, om, ov = _tensors(device, dtype, raw, x, y, q, obs_mean, obs_var)
    mu, var = predict(raw_t, X, Y, _rungs(raw_t, X, nugget), Q, mm=mm)
    return rank_implausibility(mu, var, om, ov, rank).double().cpu().numpy()
