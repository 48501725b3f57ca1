"""One-shot experimental designs (Monte Carlo / Latin Hypercube / MaxiMin).

Port of ``mogp_tpu/uq/experimental_design.py``: the same five argument
forms and PPF mapping, and the same draws from numpy's global RNG in the
same order, so that a seeded design is the same array in both packages.
MaxiMin's candidates are scored by :func:`_min_pdist_batch`, one batched
torch computation on the design's ``device`` (the card unless the caller
passes ``device="cpu"``), chunked so that the ``(chunk, n, n)`` distances
stay bounded.  The same function runs on the CPU.
"""

from inspect import signature

import numpy as np
import scipy.stats
import torch

from ..config import default_dtype, resolve_device

__all__ = [
    "ExperimentalDesign",
    "MonteCarloDesign",
    "LatinHypercubeDesign",
    "MaxiMinLHC",
]


def _as_count(value):
    """Interpret ``value`` as a parameter count, or return ``None``."""
    if isinstance(value, bool) or isinstance(value, str):
        return None
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def _as_list(value):
    """Materialize a non-string sequence as a list, or return ``None``."""
    if isinstance(value, str):
        return None
    try:
        return list(value)
    except TypeError:
        return None


def _is_bounds_pair(seq):
    """True when ``seq`` is two scalars, i.e. a ``(lo, hi)`` bounds pair."""
    if len(seq) != 2:
        return False
    for v in seq:
        if callable(v) or _as_list(v) is not None:
            return False
        try:
            float(v)
        except (TypeError, ValueError):
            return False
    return True


def _spec_to_ppf(spec):
    """Convert one parameter spec to a PPF callable.

    ``None`` -> uniform [0, 1]; ``(lo, hi)`` -> uniform [lo, hi] (requires
    ``lo < hi``); a callable must take exactly one argument.
    """
    if spec is None:
        return scipy.stats.uniform(loc=0.0, scale=1.0).ppf
    if callable(spec):
        if len(signature(spec).parameters) != 1:
            raise ValueError(
                "PPF distribution provided must accept a single argument"
            )
        return spec
    seq = _as_list(spec)
    if seq is None or not _is_bounds_pair(seq):
        raise TypeError("bounds for each parameter must be a tuple of two floats")
    lo, hi = float(seq[0]), float(seq[1])
    if hi <= lo:
        raise ValueError("bad value for parameter bounds in ExperimentalDesign")
    return scipy.stats.uniform(loc=lo, scale=hi - lo).ppf


class ExperimentalDesign:
    """Base one-shot design with uncorrelated parameters
    (``ExperimentalDesign.py:6-295``).

    Parameter space is specified by PPF (inverse-CDF) functions, one per
    parameter; sampling draws from ``[0,1]^n`` (method-specific) and maps
    through the PPFs.
    """

    def __init__(self, *args, device=None):
        """Accepts the reference's five input conventions
        (``ExperimentalDesign.py:32-188``) via a normalize-then-convert
        design: arguments are first reduced to a list of one spec per
        parameter, then each spec is turned into a PPF by
        :func:`_spec_to_ppf`.

        Conventions: ``ED(n)``, ``ED(list_of_specs)``, ``ED(n, (lo, hi))``,
        ``ED(n, ppf_callable)``, ``ED(n, list_of_specs)``; a spec is a
        ``(lo, hi)`` pair, a single-argument PPF callable, or ``None``
        (uniform on [0, 1]).  ``device`` is where :class:`MaxiMinLHC`
        scores its candidates (default: the card, resolved when scoring).
        """
        if not 1 <= len(args) <= 2:
            raise ValueError("bad inputs for ExperimentalDesign")

        specs = self._normalize_args(args)
        if len(specs) <= 0:
            raise ValueError(
                "number of parameters must be positive in Experimental Design"
            )
        self.n_parameters = len(specs)
        self.distributions = [_spec_to_ppf(spec) for spec in specs]
        self.device = device

    @staticmethod
    def _normalize_args(args):
        """Reduce constructor args to a per-parameter spec list."""
        first = args[0]
        if _as_count(first) is not None:
            n = _as_count(first)
            shared = args[1] if len(args) == 2 else None
            if len(args) == 2 and not callable(shared):
                # a 2-sequence of scalars is (lo, hi) shared bounds; any
                # other sequence is a per-parameter spec list
                seq = _as_list(shared)
                if seq is None:
                    raise TypeError("bad input type for ExperimentalDesign")
                if _is_bounds_pair(seq):
                    shared = (float(seq[0]), float(seq[1]))
                else:
                    if len(seq) != n:
                        raise ValueError(
                            "list of parameter distributions must have the "
                            "same length"
                        )
                    return seq
            return [shared] * n
        if len(args) == 2:
            raise TypeError("bad input type for ExperimentalDesign")
        seq = _as_list(first)
        if seq is None:
            raise TypeError("bad input type for ExperimentalDesign")
        return seq

    def get_n_parameters(self):
        return self.n_parameters

    def get_method(self):
        try:
            return self.method
        except AttributeError:
            raise NotImplementedError(
                "base class of ExperimentalDesign does not implement a method"
            )

    def _draw_samples(self, n_samples):
        raise NotImplementedError

    def sample(self, n_samples, **kwargs):
        """Draw parameter samples (``ExperimentalDesign.py:239-284``).

        PPF application is vectorized per parameter column."""
        n_samples = int(n_samples)
        assert n_samples > 0, "number of samples must be positive"

        random_draws = self._draw_samples(n_samples, **kwargs)
        assert np.all(random_draws >= 0.0) and np.all(random_draws <= 1.0), (
            "error in generating random samples"
        )

        sample_values = np.empty((n_samples, self.get_n_parameters()))
        for index, dist in enumerate(self.distributions):
            try:
                sample_values[:, index] = np.asarray(
                    dist(random_draws[:, index])
                ).reshape(-1)
            except (TypeError, ValueError):
                # PPF that only accepts scalars
                sample_values[:, index] = [
                    dist(v) for v in random_draws[:, index]
                ]

        assert np.all(np.isfinite(sample_values)), (
            "error due to non-finite values of parameters"
        )
        return sample_values

    def __str__(self):
        try:
            method = self.get_method() + " "
        except NotImplementedError:
            method = ""
        return (
            method
            + "Experimental Design with "
            + str(self.get_n_parameters())
            + " parameters"
        )


class MonteCarloDesign(ExperimentalDesign):
    """Monte Carlo design (``ExperimentalDesign.py:297-430``)."""

    method = "Monte Carlo"

    def _draw_samples(self, n_samples, **kwargs):
        return np.random.random((int(n_samples), self.get_n_parameters()))


class LatinHypercubeDesign(ExperimentalDesign):
    """Latin Hypercube design (``ExperimentalDesign.py:432-584``): each
    sample occupies a unique stratum of each parameter's distribution."""

    method = "Latin Hypercube"

    def _draw_samples(self, n_samples, **kwargs):
        n_samples = int(n_samples)
        assert n_samples > 0, "number of samples must be positive"
        n_parameters = self.get_n_parameters()
        # shuffled strata + intra-stratum jitter (ExperimentalDesign.py:550-580)
        strata = np.argsort(
            np.random.random((n_samples, n_parameters)), axis=0
        ).astype(np.float64)
        samples = (strata + np.random.random((n_samples, n_parameters))) / float(
            n_samples
        )
        assert np.all(samples >= 0.0) and np.all(samples <= 1.0)
        return samples


def _min_pdist_batch(candidates):
    """Minimum pairwise Euclidean distance per candidate design:
    ``candidates`` ``(n_tries, n_samples, D)`` tensor -> ``(n_tries,)``.

    The distances are taken from the differences (``torch.cdist`` without
    its matrix-product form), so that float32 on the card loses nothing
    to cancellation."""
    d = torch.cdist(candidates, candidates, compute_mode="donot_use_mm_for_euclid_dist")
    n = candidates.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=candidates.device)
    return torch.amin(torch.where(eye, torch.inf, d), dim=(1, 2))


class MaxiMinLHC(LatinHypercubeDesign):
    """MaxiMin Latin Hypercube (``ExperimentalDesign.py:586-674``): of
    ``n_tries`` LHC draws, keep the one maximizing the minimum pairwise
    distance.  All candidates are generated and scored in one batch."""

    method = "MaxiMinLHC"

    def _draw_samples(self, n_samples, n_tries=1000, **kwargs):
        n_samples = int(n_samples)
        n_tries = int(n_tries)
        assert n_samples > 0, "number of samples must be positive"
        assert n_tries > 0, "n_tries must be a positive integer"
        n_parameters = self.get_n_parameters()

        strata = np.argsort(
            np.random.random((n_tries, n_samples, n_parameters)), axis=1
        ).astype(np.float64)
        candidates = (
            strata + np.random.random((n_tries, n_samples, n_parameters))
        ) / float(n_samples)

        min_dists = self._score_candidates(candidates, self.device)
        best = int(np.argmax(min_dists))
        best_samples = candidates[best]
        assert np.all(best_samples >= 0.0) and np.all(best_samples <= 1.0)
        return best_samples

    @staticmethod
    def _score_candidates(candidates, device=None):
        """Min pairwise distance per candidate design, float64 numpy.

        One batched computation per chunk on ``device`` (float32 on the
        card, float64 on the CPU), chunked so that the ``(chunk, n, n)``
        distance tensor stays bounded in memory."""
        device = resolve_device(device)
        dtype = default_dtype(device)
        n_tries, n_samples, _ = candidates.shape
        max_elems = 1 << 26
        chunk = max(1, int(max_elems // max(n_samples * n_samples, 1)))
        min_dists = []
        with torch.no_grad():
            for c0 in range(0, n_tries, chunk):
                block = torch.as_tensor(candidates[c0 : c0 + chunk], dtype=dtype, device=device)
                min_dists.append(_min_pdist_batch(block))
        return torch.cat(min_dists).to("cpu", torch.float64).numpy()
