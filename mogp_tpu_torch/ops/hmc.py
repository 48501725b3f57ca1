"""NUTS over a lanes axis of chains.

Port of ``mogp_tpu/ops/hmc.py``: the iterative multinomial NUTS of
Hoffman & Gelman (2014) with Betancourt's (2017) multinomial sampling,
the power-of-two U-turn bookkeeping, dual-averaging step sizes and a
diagonal mass matrix from Welford windows (Stan's warmup, simplified).

The JAX package gets many chains by ``vmap`` over a ``lax.while_loop``:
every lane steps until the last lane stops, and a finished lane's updates
are masked out.  Here that is written out over a lanes axis ``(L, P)``:

* every leapfrog evaluates the potential and its gradient for all L lanes
  in one call of ``pg_fn(q (L, P)) -> (u (L,), grad (L, P))``;
* per-lane state is selected with ``torch.where`` on masks; a lane that has
  turned, diverged or reached ``max_depth`` keeps its state (and evaluates
  the potential again at the same point) until the whole batch stops, so
  its results are those of JAX's ``vmap``;
* all lanes of a batch are at the same tree depth and leaf, so the U-turn
  checkpoint indices are host integers; the host reads one flag per tree
  doubling ("is any lane still doubling") and no other value.  A subtree
  runs to its end even when every lane has stopped inside it: reading a
  flag after every second leaf to stop early saved 1% of the leapfrogs of
  64 float32 chains on bench.py's problem and no time (one H100 80GB
  HBM3 at 700 W; CHANGES.md, the inference slice).

Sampler state is float64 whatever the potential's type: positions,
momenta, energies, log-weights, dual averaging and the Welford windows are
small, and ``pg_fn`` casts to the type it evaluates in.

Random numbers are counter based (Philox4x32-10, Salmon et al. 2011,
written in int64 torch ops): every draw of a lane is a function of (seed,
output, chain, transition index, slot) alone.  A chain's samples
therefore do not depend on which other lanes share its batch, a run split
into segments equals the run in one piece, and a checkpoint needs only
the transition index to resume the stream.  The JAX package's
``jax.random`` streams are other numbers, so the two packages agree in
distribution, not in bits.  A non-finite potential counts as a divergence
(``max_delta=1000``), as in JAX.
"""

import threading
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "NUTSInfo",
    "Stream",
    "philox4x32",
    "seeded_generator",
    "nuts_step",
    "nuts_kernel",
    "sample_nuts",
    "potential_and_grad",
    "nuts_warmup_init",
    "nuts_warmup_segment",
    "nuts_warmup_finish",
    "nuts_sample_segment",
    "counters",
]


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor   # (L,) mean acceptance statistic of the tree
    step_size: torch.Tensor     # (L,)
    n_leapfrog: torch.Tensor    # (L,) int64
    diverging: torch.Tensor     # (L,) bool
    energy: torch.Tensor        # (L,) potential at the proposal


class Counters:
    """What the lockstep costs, over the calls since :meth:`reset`:
    ``transitions``, ``leapfrogs`` (batched potential evaluations),
    ``lane_leapfrogs`` (lanes x leapfrogs), ``useful`` (lane-leapfrogs
    whose result a lane kept; a device tensor per device, read by
    :meth:`read`) and ``syncs`` (flags read by the host).  :meth:`add` takes
    a lock: the shards of a mesh of several cards step from threads of
    their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.transitions = self.leapfrogs = self.lane_leapfrogs = self.syncs = 0
            self._useful = {}

    def add(self, useful=None, **counts):
        """Add ``counts`` to the named integer counters, and ``useful`` (a
        device tensor) to its device's sum."""
        with self._lock:
            for name, n in counts.items():
                setattr(self, name, getattr(self, name) + n)
            if useful is not None:
                dev = useful.device
                self._useful[dev] = self._useful.get(dev, 0) + useful

    def read(self):
        with self._lock:
            useful = sum(int(u) for u in self._useful.values())
        return {
            "transitions": self.transitions,
            "leapfrogs": self.leapfrogs,
            "lane_leapfrogs": self.lane_leapfrogs,
            "useful_lane_leapfrogs": useful,
            "lane_utilization": useful / max(self.lane_leapfrogs, 1),
            "syncs": self.syncs,
        }


counters = Counters()


def potential_and_grad(potential_fn):
    """``pg_fn`` for a batched potential ``(L, P) -> (L,)`` by autograd."""

    def pg(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            u = potential_fn(x)
            (g,) = torch.autograd.grad(u.sum(), x)
        return u.detach(), g

    return pg


# ---------------------------------------------------------------------------
# Counter-based random numbers
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m, x):
    """High and low 32-bit words of ``m * x`` for a 32-bit constant ``m``
    and int64 tensor ``x`` of 32-bit words, through 16-bit halves so that
    no int64 product overflows."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10: four 32-bit counter words (int64 tensors that
    broadcast; ``counter[1]`` may be an int) and two key words (ints) ->
    four tensors of 32-bit output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


class Stream:
    """The random stream of a batch of lanes: Philox keyed by ``seed``,
    counters ``(block, transition, chain, output)`` per lane.

    :param chains, outputs: ``(L,)`` integer tensors on the lanes' device.
    """

    def __init__(self, seed, chains, outputs):
        seed = int(seed) & (2**64 - 1)
        self.key = (seed & _MASK32, seed >> 32)
        self.chains = chains.to(torch.int64)[:, None] & _MASK32
        self.outputs = outputs.to(torch.int64)[:, None] & _MASK32

    def uniforms(self, t, n):
        """``(L, n)`` float64 uniforms in (0, 1], 53 random bits each, for
        transition ``t``."""
        blocks = torch.arange((n + 1) // 2, dtype=torch.int64, device=self.chains.device)
        w = philox4x32((blocks[None, :], int(t) & _MASK32, self.chains, self.outputs), self.key)
        u = []
        for a, b in ((w[0], w[1]), (w[2], w[3])):
            k = (a >> 5) * 67108864 + (b >> 6)
            u.append((k.to(torch.float64) + 0.5) * 2.0**-53)
        return torch.stack(u, dim=-1).reshape(u[0].shape[0], -1)[:, :n]


def seeded_generator(device, *words):
    """A ``torch.Generator`` on ``device`` seeded from non-negative
    integers (``numpy.random.SeedSequence`` mixes them into 64 bits): the
    stream of one chain's start, one VI run or one SMC stage."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) | (int(state[1]) << 32))


def _normals(u):
    """Box-Muller: ``(L, 2k)`` uniforms -> ``(L, 2k)`` standard normals."""
    u1, u2 = u[:, 0::2], u[:, 1::2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    return torch.stack([r * torch.cos(2 * np.pi * u2), r * torch.sin(2 * np.pi * u2)],
                       dim=-1).reshape(u.shape)


class _Draws(NamedTuple):
    momentum: torch.Tensor   # (L, P) standard normals
    direction: torch.Tensor  # (L, max_depth) uniforms
    accept: torch.Tensor     # (L, max_depth)
    leaf: torch.Tensor       # (L, 2**max_depth - 1), leaf k of depth d at 2**d - 1 + k


def _transition_draws(stream, t, P, max_depth):
    """Every number one transition may use, in one Philox call."""
    n_norm = P + P % 2
    n_leaf = 2**max_depth - 1
    u = stream.uniforms(t, n_norm + 2 * max_depth + n_leaf)
    o = n_norm
    return _Draws(_normals(u[:, :n_norm])[:, :P], u[:, o:o + max_depth],
                  u[:, o + max_depth:o + 2 * max_depth], u[:, o + 2 * max_depth:])


# ---------------------------------------------------------------------------
# Dual averaging, leapfrog, U-turn
# ---------------------------------------------------------------------------

class _DAState(NamedTuple):
    """Dual-averaging state (Hoffman & Gelman 2014, eq. 6), per lane."""

    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(step_size):
    return _DAState(
        log_step=torch.log(step_size),
        log_step_avg=torch.zeros_like(step_size),
        h_avg=torch.zeros_like(step_size),
        mu=torch.log(10.0 * step_size),
        count=torch.zeros_like(step_size),
    )


def _da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * state.h_avg + (target - accept_prob) / (count + t0)
    log_step = state.mu - torch.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return _DAState(log_step, log_step_avg, h_avg, state.mu, count)


def _leapfrog(pg_fn, inv_mass, step_size, q, p, grad):
    """One leapfrog step of every lane; ``step_size`` ``(L, 1)``."""
    p_half = p - 0.5 * step_size * grad
    q_new = q + step_size * inv_mass * p_half
    u_new, grad_new = pg_fn(q_new)
    p_new = p_half - 0.5 * step_size * grad_new
    return q_new, p_new, u_new, grad_new


def _kinetic(inv_mass, p):
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1)


def _is_turning(inv_mass, p_left, p_right, p_sum):
    """Generalized U-turn criterion on a trajectory segment, per lane."""
    v = inv_mass * p_sum
    return (torch.sum(v * p_left, dim=-1) <= 0.0) | (torch.sum(v * p_right, dim=-1) <= 0.0)


def _select(mask, new, old):
    """``torch.where`` over the fields of two NamedTuples (or tensors),
    ``mask`` ``(L,)``."""
    if isinstance(new, tuple):
        return type(new)(*[_select(mask, a, b) for a, b in zip(new, old)])
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


class _Tree(NamedTuple):
    q_left: torch.Tensor
    p_left: torch.Tensor
    grad_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    grad_right: torch.Tensor
    q_prop: torch.Tensor       # current proposal (multinomial draw)
    grad_prop: torch.Tensor
    u_prop: torch.Tensor       # potential at the proposal
    log_weight: torch.Tensor   # log sum of exp(-energy) over the tree
    p_sum: torch.Tensor        # sum of momenta across the trajectory
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor   # sum of min(1, exp(H0 - H)) for adaptation
    n_steps: torch.Tensor


class _Leaf(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor
    log_w: torch.Tensor
    p_sum: torch.Tensor
    q_prop: torch.Tensor
    grad_prop: torch.Tensor
    u_prop: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_acc: torch.Tensor


def _popcount(i):
    return bin(i).count("1")


def _trailing_ones(i):
    n = 0
    while i & 1:
        n, i = n + 1, i >> 1
    return n


def _build_subtree(pg_fn, inv_mass, step_size, depth, max_depth, direction, energy0,
                   tree, leaf_u, active, max_delta):
    """Extend every active lane's trajectory by ``2**depth`` leapfrog steps
    in its ``direction`` (``mogp_tpu/ops/hmc.py:155-263``).

    U-turn detection uses the iterative checkpoint scheme: momentum and
    the running momentum sum are stored at even leaf indices (slot
    ``popcount(i >> 1)``); every odd leaf checks the generalized U-turn
    criterion against the checkpoints of all balanced subtrees that end at
    it (slots ``popcount(i >> 1) - trailing_ones(i) + 1 .. popcount(i >>
    1)``).  A lane stops at its first U-turn or divergence (or when it is
    not ``active``) and keeps its carry from then on.
    """
    L, P = tree.q_left.shape
    stack = max(int(max_depth), 1)
    fwd = (direction > 0)[:, None]
    q0 = torch.where(fwd, tree.q_right, tree.q_left)
    p0 = torch.where(fwd, tree.p_right, tree.p_left)
    g0 = torch.where(fwd, tree.grad_right, tree.grad_left)
    false = torch.zeros(L, dtype=torch.bool, device=q0.device)
    c = _Leaf(q0, p0, g0, torch.full((L,), -np.inf, dtype=q0.dtype, device=q0.device),
              torch.zeros_like(p0), q0, g0, torch.zeros_like(energy0), false, false,
              torch.zeros_like(energy0))
    r_ckpts = q0.new_zeros((L, stack, P))
    r_sum_ckpts = q0.new_zeros((L, stack, P))
    eps = (direction * step_size)[:, None]
    first = 2**depth - 1

    for i in range(2**depth):
        going = active & ~(c.turning | c.diverging)
        q, p, u, grad = _leapfrog(pg_fn, inv_mass, eps, c.q, c.p, c.grad)
        counters.add(leapfrogs=1, lane_leapfrogs=L, useful=going.sum())
        energy = u + _kinetic(inv_mass, p)
        energy = torch.where(torch.isnan(energy), np.inf, energy)
        delta = energy - energy0
        log_wi = -delta

        # multinomial progressive sampling within the subtree
        log_w = torch.logaddexp(c.log_w, log_wi)
        accept = torch.log(leaf_u[:, first + i]) < log_wi - log_w
        a = accept[:, None]
        p_sum = c.p_sum + p
        turning = c.turning
        idx_max = _popcount(i >> 1)
        if i % 2 == 0:
            keep = going[:, None]
            r_ckpts[:, idx_max] = torch.where(keep, p, r_ckpts[:, idx_max])
            r_sum_ckpts[:, idx_max] = torch.where(keep, p_sum, r_sum_ckpts[:, idx_max])
        else:
            for k in range(idx_max - _trailing_ones(i) + 1, idx_max + 1):
                r_left = r_ckpts[:, k]
                segment = p_sum - r_sum_ckpts[:, k] + r_left
                turning = turning | _is_turning(inv_mass, r_left, p, segment)
        new = _Leaf(
            q, p, grad, log_w, p_sum,
            torch.where(a, q, c.q_prop), torch.where(a, grad, c.grad_prop),
            torch.where(accept, u, c.u_prop), turning, c.diverging | (delta > max_delta),
            c.sum_acc + torch.clamp_max(torch.exp(-delta), 1.0),
        )
        c = _select(going, new, c)
    return c


def nuts_step(pg_fn, q, u, grad, step_size, inv_mass, draws, max_depth=8, max_delta=1000.0):
    """One NUTS transition of every lane (``mogp_tpu/ops/hmc.py:266-384``).

    :param q, grad: ``(L, P)`` float64; ``u``, ``step_size``: ``(L,)``;
        ``inv_mass``: ``(L, P)``; ``draws``: this transition's ``_Draws``.
    :returns: ``(q', u', grad', NUTSInfo)``.
    """
    L = q.shape[0]
    p0 = draws.momentum / torch.sqrt(inv_mass)
    energy0 = u + _kinetic(inv_mass, p0)
    false = torch.zeros(L, dtype=torch.bool, device=q.device)
    tree = _Tree(q, p0, grad, q, p0, grad, q, grad, u, torch.zeros_like(u), p0, false, false,
                 torch.zeros_like(u), torch.zeros(L, dtype=torch.int64, device=q.device))
    active = ~false
    counters.add(transitions=1)
    for depth in range(max_depth):
        if depth > 0:
            counters.add(syncs=1)
            if not bool(active.any()):
                break
        direction = torch.where(draws.direction[:, depth] < 0.5, 1.0, -1.0).to(q.dtype)
        sub = _build_subtree(pg_fn, inv_mass, step_size, depth, max_depth, direction, energy0,
                             tree, draws.leaf, active, max_delta)
        fwd = (direction > 0)[:, None]
        q_left = torch.where(fwd, tree.q_left, sub.q)
        p_left = torch.where(fwd, tree.p_left, sub.p)
        grad_left = torch.where(fwd, tree.grad_left, sub.grad)
        q_right = torch.where(fwd, sub.q, tree.q_right)
        p_right = torch.where(fwd, sub.p, tree.p_right)
        grad_right = torch.where(fwd, sub.grad, tree.grad_right)

        # biased progressive sampling between the old tree and the subtree
        ok = ~(sub.turning | sub.diverging)
        log_ratio = sub.log_w - tree.log_weight
        accept = ok & (torch.log(draws.accept[:, depth]) < torch.clamp_max(log_ratio, 0.0))
        a = accept[:, None]
        p_sum = tree.p_sum + torch.where(ok[:, None], sub.p_sum, 0.0)
        turning_total = ~ok | _is_turning(inv_mass, p_left, p_right, p_sum)
        new = _Tree(
            q_left, p_left, grad_left, q_right, p_right, grad_right,
            torch.where(a, sub.q_prop, tree.q_prop), torch.where(a, sub.grad_prop, tree.grad_prop),
            torch.where(accept, sub.u_prop, tree.u_prop),
            torch.where(ok, torch.logaddexp(tree.log_weight, sub.log_w), tree.log_weight),
            p_sum, sub.turning | turning_total, tree.diverging | sub.diverging,
            tree.sum_accept + sub.sum_acc, tree.n_steps + 2**depth,
        )
        tree = _select(active, new, tree)
        active = active & ~(tree.turning | tree.diverging)

    accept_prob = tree.sum_accept / torch.clamp_min(tree.n_steps.to(q.dtype), 1.0)
    info = NUTSInfo(accept_prob, step_size, tree.n_steps, tree.diverging, tree.u_prop)
    return tree.q_prop, tree.u_prop, tree.grad_prop, info


def nuts_kernel(potential_fn, max_depth=8, max_delta=1000.0):
    """A NUTS transition for the batched potential ``potential_fn`` ``(L, P)
    -> (L,)`` (``mogp_tpu/ops/hmc.py:266``): the gradient by autograd
    (:func:`potential_and_grad`) and one :func:`nuts_step`.

    Returns ``step(stream, t, q, u, grad, step_size, inv_mass) -> (q', u',
    grad', NUTSInfo)``: the random numbers are transition ``t``'s of the
    :class:`Stream` ``stream``, where ``mogp_tpu`` takes a JAX key.
    """
    pg_fn = potential_and_grad(potential_fn)

    def step(stream, t, q, u, grad, step_size, inv_mass):
        draws = _transition_draws(stream, t, q.shape[1], max_depth)
        return nuts_step(pg_fn, q, u, grad, step_size, inv_mass, draws, max_depth, max_delta)

    return step


# ---------------------------------------------------------------------------
# Welford windows and the chains
# ---------------------------------------------------------------------------

class _WelfordState(NamedTuple):
    mean: torch.Tensor   # (L, P)
    m2: torch.Tensor     # (L, P)
    count: torch.Tensor  # (L,)


def _welford_init(q):
    return _WelfordState(torch.zeros_like(q), torch.zeros_like(q), q.new_zeros(q.shape[0]))


def _welford_update(state, x):
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[:, None]
    m2 = state.m2 + delta * (x - mean)
    return _WelfordState(mean, m2, count)


def _welford_var(state, regularize=True):
    n = state.count[:, None]
    var = state.m2 / torch.clamp_min(n - 1.0, 1.0)
    if regularize:
        # Stan-style shrinkage towards unit
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


class NUTSWarmupCarry(NamedTuple):
    q: torch.Tensor
    u: torch.Tensor
    grad: torch.Tensor
    da: _DAState
    inv_mass: torch.Tensor
    welford: _WelfordState


class NUTSSampleCarry(NamedTuple):
    q: torch.Tensor
    u: torch.Tensor
    grad: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor


def nuts_warmup_init(pg_fn, q0, init_step_size=0.1):
    """Initial warmup carry of the lanes ``q0`` ``(L, P)`` (float64)."""
    u0, grad0 = pg_fn(q0)
    return NUTSWarmupCarry(
        q0, u0, grad0, _da_init(torch.full_like(u0, init_step_size)),
        torch.ones_like(q0), _welford_init(q0),
    )


def nuts_warmup_segment(pg_fn, carry, stream, i0, n_seg, m1, m2, max_depth=8,
                        target_accept=0.8):
    """Advance warmup by ``n_seg`` transitions from global index ``i0``.
    The mass-matrix refreshes fire at the global indices ``m1`` / ``m2``
    (50% / 90% of the whole warmup), so any segmentation composes to the
    run in one piece."""
    c = carry
    for i in range(i0, i0 + n_seg):
        draws = _transition_draws(stream, i, c.q.shape[1], max_depth)
        q, u, grad, info = nuts_step(pg_fn, c.q, c.u, c.grad, torch.exp(c.da.log_step),
                                     c.inv_mass, draws, max_depth)
        da = _da_update(c.da, info.accept_prob, target=target_accept)
        welford = _welford_update(c.welford, q)
        inv_mass = c.inv_mass
        if i == m1 or i == m2:
            inv_mass = _welford_var(welford)
            da = _da_init(torch.exp(da.log_step_avg))
            welford = _welford_init(q)
        c = NUTSWarmupCarry(q, u, grad, da, inv_mass, welford)
    return c


def nuts_warmup_finish(carry):
    """Freeze the adapted step size and mass matrix into a sampling carry."""
    return NUTSSampleCarry(carry.q, carry.u, carry.grad, torch.exp(carry.da.log_step_avg),
                           carry.inv_mass)


def nuts_sample_segment(pg_fn, carry, stream, t0, n_seg, max_depth=8):
    """Draw ``n_seg`` samples from global transition index ``t0``.

    :returns: ``(carry, samples (L, n_seg, P), NUTSInfo of (L, n_seg))``.
    """
    c = carry
    samples, infos = [], []
    for t in range(t0, t0 + n_seg):
        draws = _transition_draws(stream, t, c.q.shape[1], max_depth)
        q, u, grad, info = nuts_step(pg_fn, c.q, c.u, c.grad, c.step_size, c.inv_mass, draws,
                                     max_depth)
        c = NUTSSampleCarry(q, u, grad, c.step_size, c.inv_mass)
        samples.append(q)
        infos.append(info)
    return c, torch.stack(samples, dim=1), NUTSInfo(*[torch.stack(x, dim=1) for x in zip(*infos)])


def sample_nuts(pg_fn, q0, seed, n_warmup=500, n_samples=500, max_depth=8, target_accept=0.8,
                init_step_size=0.1):
    """Run ``L`` chains (the lanes of ``q0``, float64 ``(L, P)``): warmup
    with dual averaging and a diagonal mass matrix, then sampling.  Lane
    ``c`` draws the stream of chain ``c`` of output 0 of ``seed``.

    :returns: ``(samples (L, n_samples, P), NUTSInfo of (L, n_samples))``.
    """
    L = q0.shape[0]
    stream = Stream(seed, torch.arange(L, device=q0.device), torch.zeros(L, device=q0.device))
    carry = nuts_warmup_init(pg_fn, q0, init_step_size)
    carry = nuts_warmup_segment(pg_fn, carry, stream, 0, n_warmup, int(n_warmup * 0.5),
                                int(n_warmup * 0.9), max_depth, target_accept)
    _, samples, infos = nuts_sample_segment(pg_fn, nuts_warmup_finish(carry), stream, n_warmup,
                                            n_samples, max_depth)
    return samples, infos
