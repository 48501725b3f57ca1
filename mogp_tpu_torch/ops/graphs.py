"""CUDA graphs of the port's launch-bound loops: capture once, replay often.

An eager value and gradient of ``gp_nlp`` at n = 210 is ~400 kernel
launches, which the host enqueues slower than the card runs them.  A CUDA
graph of the same work runs the same kernels, on the values then in the
tensors it was captured on, from one host call.  Two callers capture:
NUTS's potential (``models/inference.py::_GraphedPotential``) and the MAP
fit's lockstep L-BFGS (``ops/lbfgs.py``, the segments between its host
reads).

:func:`capture` holds the discipline both use: one capture at a time in
the process, on a side stream of the data's device, after two warm-up
calls outside capture (library handles, workspaces), with
``capture_error_mode="thread_local"`` (the shards of a mesh of several
cards allocate from threads of their own meanwhile).  Nothing inside a
captured function may copy from the host or read the device.

What a capture records besides the kernels is put back at each replay
(:class:`Graph`): K2's launches (``ops/cholesky_batched.py::replay``) and
the program's counters (``utils/metrics.py``), which the capture tallies
instead of recording, since it runs nothing.  :data:`captures` and
:data:`replays` count the graphs made and replayed in this process.
"""

import threading

import torch

from ..utils import metrics
from . import cholesky_batched as kb

__all__ = ["Graph", "capture", "WARMUPS", "captures", "replays"]

# eager calls before a capture: the first makes the library handles and
# workspaces, the second runs as the graph will
WARMUPS = 2

# graphs captured and replayed in this process; callers may reset them
captures = 0
replays = 0

# one CUDA graph capture at a time in the process: the shards of a mesh of
# several cards capture from threads of their own, and a capture's set-up
# (a synchronize, the allocator's cache emptied, the device's random-number
# generator registered with the graph) must not meet another capture
_capture_lock = threading.Lock()


class Graph:
    """A captured graph: :meth:`replay` runs it and adds what its capture
    recorded, ``n_k2`` launches of K2 and the counts ``counts``."""

    def __init__(self, graph, n_k2, counts):
        self._graph = graph
        self.n_k2 = n_k2
        self.counts = dict(counts)

    def replay(self):
        global replays
        kb.replay(self._graph, self.n_k2)
        for name, n in self.counts.items():
            metrics.count(name, n)
        with metrics.count_lock:
            replays += 1


def capture(fn, device):
    """Capture ``fn()`` into a CUDA graph on ``device``.

    ``fn`` runs :data:`WARMUPS` times eagerly first (its counts and spans
    recorded as any eager call's), then once under capture, where it runs
    nothing.  The tensors it reads and writes must outlive the graph: a
    replay reads and writes the same memory.

    :returns: ``(Graph, out)``, ``out`` what the captured call returned,
        in the graph's own memory, which each replay writes again.
    """
    global captures
    with _capture_lock:
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUPS):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kb.recorded_here()
        # on a stream of the data's device: torch.cuda.graph's default
        # capture stream is one for the process, made on the device of its
        # first use; thread_local: the other shards' threads allocate
        # meanwhile
        with metrics.tally() as counts, torch.cuda.graph(graph, stream=side,
                                                         capture_error_mode="thread_local"):
            out = fn()
        n_k2 = kb.recorded_here() - before
        with metrics.count_lock:
            captures += 1
    return Graph(graph, n_k2, counts), out
