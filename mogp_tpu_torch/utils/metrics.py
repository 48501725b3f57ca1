"""Timing, throughput metrics and profiling (port of ``mogp_tpu/utils/metrics.py``).

* ``Timer`` / ``PhaseTimer`` -- wall-clock timing; ``Timer.sync`` waits for
  the card (``torch.cuda.synchronize``) when an output lies on it, so
  asynchronous CUDA work is measured, not just enqueued.
* The program's recorder, one ``PhaseTimer`` of this process: ``span`` and
  ``count`` at the boundaries of its layers, read by ``spans`` and
  ``counters`` (see "The recorder" below).
* FLOP estimators for the hot ops, the same formulas as ``mogp_tpu``, and
  the derived ``tflops_per_sec``.
* ``fits_per_sec`` / ``ess_per_sec`` -- headline throughput metrics.
* ``profile_trace`` -- context manager around ``torch.profiler``, writing a
  Chrome trace.
"""

import contextlib
import itertools
import logging
import os
import threading
import time
from typing import NamedTuple, Optional

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
    "SpanRecord",
    "recorder",
    "span",
    "timed_span",
    "count",
    "recording",
    "tally",
    "enabled",
    "spans",
    "counters",
    "clear",
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
    optimize ...); prints a table on demand.

    The program's recorder (:data:`recorder`) is one too: each span it
    records adds its seconds to ``totals`` and ``counts`` under its name,
    so that ``report()`` tables them, and is kept whole in ``records``;
    ``counters`` holds the named counts of :func:`count`."""

    def __init__(self):
        self.totals = {}
        self.counts = {}
        self.records = []
        self.counters = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def _add(self, name, seconds):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = ["{:<24} {:>10} {:>12}".format("phase", "calls", "seconds")]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                "{:<24} {:>10} {:>12.4f}".format(name, self.counts[name], self.totals[name])
            )
        return "\n".join(lines)


# -- The recorder --------------------------------------------------------------
#
# Spans and counters at the boundaries of the program's layers, named layer
# first (``fitting.stage``, ``lbfgs.sync``, ``gp.nlp``, ``hm.inputs``, ...).
# The recorder is on exactly while a ``torch.profiler`` records on the calling
# thread (or on the thread whose ``map_shards`` started it: ``adopt``) or a
# ``recording()`` block is open; off, ``span`` and ``count`` cost a check or
# two and record nothing.  On, each span also opens
# ``torch.profiler.record_function(name)`` under a profiler, which puts it in
# the profiler's trace on the device events' clock.  Everything stays in
# memory, until ``clear()``; nothing is written to disk.  Inside ``tally()``
# (a CUDA graph's capture, ``ops/graphs.py``) the thread records no span and
# its counts go to the tally instead, which each replay of the graph adds.


class SpanRecord(NamedTuple):
    """One finished span.  Times are ``time.perf_counter_ns()``; ``parent``
    is the ``id`` of the span that was open on the same thread when it
    opened (for a span on a thread of ``parallel.mesh.map_shards``, the
    span that called it), ``None`` for the root of a request; ``request``
    is the identifier that the root opened (its own ``id``), shared by
    every span beneath it; ``attrs`` the few small values the span was given."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: int
    attrs: dict

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9


# guards the recorder and every kernel wrapper's launch counter
# (``ops/_build.py`` hands it to them): the shards of a mesh of several cards
# record and launch from threads of their own (parallel/mesh.py::map_shards)
count_lock = threading.Lock()
# the process's recorder; its lists and dicts change under ``count_lock``
recorder = PhaseTimer()
_local = threading.local()
_span_ids = itertools.count(1)
_recording = 0
_switch = threading.Lock()
_profiler_enabled = torch._C._autograd._profiler_enabled


def enabled():
    """Whether the recorder is on for the calling thread."""
    if getattr(_local, "tally", None) is not None:
        return False
    return bool(_recording) or _profiler_enabled() or getattr(_local, "adopted", False)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span of :func:`span` or :func:`timed_span`: always timed
    (``seconds`` once closed), recorded only where ``record``."""

    __slots__ = ("name", "attrs", "record", "id", "parent", "request", "start_ns", "end_ns",
                 "_rf")

    def __init__(self, name, attrs, record):
        self.name, self.attrs, self.record = name, attrs, record
        self._rf = None

    def __enter__(self):
        if self.record:
            stack = _stack()
            parent = stack[-1] if stack else None
            self.id = next(_span_ids)
            self.parent = None if parent is None else parent.id
            self.request = self.id if parent is None else parent.request
            stack.append(self)
            if _profiler_enabled():
                self._rf = torch.autograd.profiler.record_function(self.name)
                self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.record:
            if self._rf is not None:
                self._rf.__exit__(*exc)
            _stack().pop()
            rec = SpanRecord(self.name, self.start_ns, self.end_ns, self.id, self.parent,
                             self.request, self.attrs)
            with count_lock:
                recorder.records.append(rec)
                recorder._add(self.name, rec.seconds)
        return False

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9


# what :func:`span` returns while the recorder is off
_OFF = contextlib.nullcontext()


def span(name, **attrs):
    """A context manager recording the span ``name`` with ``attrs`` while
    the recorder is on; off, it does nothing."""
    return _Span(name, attrs, True) if enabled() else _OFF


def timed_span(name, **attrs):
    """As :func:`span`, but timed whether the recorder is on or not: its
    ``seconds`` after it closes feed the program's own phase clocks
    (``models/fitting.py::last_phase_times``)."""
    return _Span(name, attrs, enabled())


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while the recorder is on, or to
    the open :func:`tally` of the calling thread."""
    tallied = getattr(_local, "tally", None)
    if tallied is not None:
        tallied[name] = tallied.get(name, 0) + n
    elif enabled():
        with count_lock:
            recorder.counters[name] = recorder.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn the recorder on, for every thread of the process, while the
    block runs: the switch without a profiler."""
    global _recording
    with _switch:
        _recording += 1
    try:
        yield
    finally:
        with _switch:
            _recording -= 1


@contextlib.contextmanager
def tally():
    """Within the block the calling thread records no span, and its counts
    go to the yielded ``{name: total}``, whether the recorder is on or not:
    the work of a CUDA graph's capture, which runs nothing, and whose
    counts each replay adds (``ops/graphs.py``)."""
    outer, _local.tally = getattr(_local, "tally", None), {}
    try:
        yield _local.tally
    finally:
        _local.tally = outer


def current_span():
    """The innermost span recording on the calling thread, or ``None``."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def adopt(parent):
    """Within the block, the calling thread's spans name ``parent`` (a span
    of another thread, from :func:`current_span`) as their parent and are
    recorded: ``map_shards``' worker threads, which a profiler started on
    the caller's thread does not record.  Only the calling thread records
    for it.  ``None`` changes nothing."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(parent)
    adopted, _local.adopted = getattr(_local, "adopted", False), True
    try:
        yield
    finally:
        _local.adopted = adopted
        stack.pop()


def spans():
    """The recorded spans, in the order they closed."""
    with count_lock:
        return list(recorder.records)


def counters():
    """The recorded counters, ``{name: total}``."""
    with count_lock:
        return dict(recorder.counters)


def clear():
    """Empty the recorder."""
    with count_lock:
        recorder.__init__()


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
