"""Timing, throughput metrics and profiling (port of ``mogp_tpu/utils/metrics.py``).

* ``Timer`` / ``PhaseTimer`` -- wall-clock timing; ``Timer.sync`` waits for
  the card (``torch.cuda.synchronize``) when an output lies on it, so
  asynchronous CUDA work is measured, not just enqueued.
* FLOP estimators for the hot ops, the same formulas as ``mogp_tpu``, and
  the derived ``tflops_per_sec``.
* ``fits_per_sec`` / ``ess_per_sec`` -- headline throughput metrics.
* ``profile_trace`` -- context manager around ``torch.profiler``, writing a
  Chrome trace.
"""

import contextlib
import logging
import os
import time

import numpy as np
import torch

__all__ = [
    "Timer",
    "PhaseTimer",
    "flops_kernel_matrix",
    "flops_cholesky",
    "flops_gp_nlp",
    "tflops_per_sec",
    "fits_per_sec",
    "ess_per_sec",
    "profile_trace",
    "get_logger",
]


def get_logger(name="mogp_tpu_torch"):
    """Framework logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class Timer:
    """Context manager measuring wall time with device sync.

    >>> with Timer() as t:
    ...     out = fn(x)
    ...     t.sync(out)
    >>> t.elapsed
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.elapsed = None
        return self

    def sync(self, *outputs):
        """Wait until the given outputs are computed: a CUDA synchronize for
        each card that holds one of them (CPU tensors are ready)."""
        devices = {out.device for out in outputs
                   if isinstance(out, torch.Tensor) and out.device.type == "cuda"}
        for device in devices:
            torch.cuda.synchronize(device)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


class PhaseTimer:
    """Accumulating per-phase timings (K-build / factorize / solve /
    optimize ...); prints a table on demand."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = ["{:<24} {:>10} {:>12}".format("phase", "calls", "seconds")]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                "{:<24} {:>10} {:>12.4f}".format(name, self.counts[name], self.totals[name])
            )
        return "\n".join(lines)


# -- FLOP estimators ---------------------------------------------------------

def flops_kernel_matrix(n, m, D):
    """FLOPs for one kernel-matrix build (matmul form + elementwise)."""
    return 2.0 * n * m * D + 10.0 * n * m


def flops_cholesky(n):
    """FLOPs for one n x n Cholesky factorization."""
    return n**3 / 3.0


def flops_gp_nlp(n, D, n_mean=0, adaptive_candidates=6):
    """Approximate FLOPs for one negative-log-posterior evaluation."""
    return (
        flops_kernel_matrix(n, n, D)
        + adaptive_candidates * flops_cholesky(n)
        + 2.0 * n * n * (2 + n_mean)  # solves
    )


def tflops_per_sec(flops, seconds):
    return flops / seconds / 1e12


def fits_per_sec(n_fits, seconds):
    """Emulator fits per second (the tsunami-benchmark headline metric)."""
    return n_fits / seconds


def ess_per_sec(ess, seconds):
    """Effective samples per second for MCMC runs (per parameter, use the
    minimum across parameters for a conservative figure)."""
    return float(np.min(ess)) / seconds


@contextlib.contextmanager
def profile_trace(logdir):
    """``torch.profiler`` over the block, CPU and (when present) CUDA
    activity; the Chrome trace goes to ``logdir/trace.json``.  Yields the
    profiler, whose ``key_averages()`` sums the time by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
