"""The device trace of a ``--trace 1`` run, reduced to what the metrics read.

``torch.profiler`` records the window (host operations and the device's
kernels, copies and sets).  :func:`reduce_events` turns its raw events into

* ``busy_s``: the length of the *union* of the device's intervals inside the
  window, so that work on two streams at once counts once;
* ``kernel_s``: the same union over compute kernels alone (no copies);
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the ten longest stretches of the window in which the device
  ran nothing, each named by the innermost host operation or span that was
  running at its middle.

Nothing is written to disk: the events are read from the profiler in
memory.
"""

import contextlib

import numpy as np

WINDOW_SPAN = "portbench.window"


def union_length(starts, ends):
    """Total length covered by the intervals ``[starts[i], ends[i])``."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    total, cur_s, cur_e = 0.0, None, None
    for s, e in zip(np.asarray(starts)[order], np.asarray(ends)[order]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return float(total + (cur_e - cur_s))


def idle_gaps(starts, ends, lo, hi):
    """The stretches of ``[lo, hi)`` that no interval covers, as
    ``(start, end)`` pairs."""
    order = np.argsort(starts, kind="stable")
    gaps, reach = [], lo
    for s, e in zip(np.asarray(starts)[order], np.asarray(ends)[order]):
        if s > reach:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


def _clip(starts, ends, lo, hi):
    s, e = np.clip(starts, lo, hi), np.clip(ends, lo, hi)
    keep = e > s
    return s[keep], e[keep], keep


def reduce_events(device, host, window):
    """Reduce the events of one traced window.

    :param device: ``(names, starts, ends, is_kernel)``: the device's
        operations, times in seconds on one clock.
    :param host: ``(names, starts, ends)``: host operations and spans.
    :param window: ``(start, end)`` of the window on the same clock.
    """
    lo, hi = window
    names, starts, ends, is_kernel = device
    s, e, keep = _clip(np.asarray(starts, float), np.asarray(ends, float), lo, hi)
    names = np.asarray(names, dtype=object)[keep]
    kern = np.asarray(is_kernel, bool)[keep]
    by_name = {}
    for n, d in zip(names, e - s):
        by_name[n] = by_name.get(n, 0.0) + float(d)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    h_names = np.asarray(host[0], dtype=object)
    h_s, h_e = np.asarray(host[1], float), np.asarray(host[2], float)
    gaps = sorted(idle_gaps(s, e, lo, hi), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = (h_s <= mid) & (h_e >= mid)
        if cover.any():
            idx = np.flatnonzero(cover)
            name = str(h_names[idx[np.argmin((h_e - h_s)[idx])]])
        else:
            name = "no host operation"
        named.append([name, float(b - a)])
    return {
        "busy_s": union_length(s, e),
        "kernel_s": union_length(s[kern], e[kern]),
        "window_s": float(hi - lo),
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": named,
    }


def reduce_profile(prof):
    """:func:`reduce_events` of a stopped ``torch.profiler.profile`` whose
    window ran inside ``record_function(WINDOW_SPAN)``.  It reads the
    profiler's raw events: the per-event Python objects of ``events()``
    take minutes to build for the million events of a traced fit."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_n, dev_s, dev_e, dev_k = [], [], [], []
    host_n, host_s, host_e = [], [], []
    window = None
    for ev in prof.profiler.kineto_results.events():
        t0 = ev.start_ns() * 1e-9
        t1 = t0 + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():  # not a host span's shadow on the device
                dev_n.append(name)
                dev_s.append(t0)
                dev_e.append(t1)
                dev_k.append(not name.startswith(("Memcpy", "Memset")))
        elif name != "Activity Buffer Request":  # the profiler's own
            if name == WINDOW_SPAN:
                window = (t0, t1)
            host_n.append(name)
            host_s.append(t0)
            host_e.append(t1)
    if window is None:
        raise RuntimeError("the trace holds no {} span".format(WINDOW_SPAN))
    return reduce_events((dev_n, dev_s, dev_e, dev_k), (host_n, host_s, host_e), window)


class Tracer:
    """Profiles the window when ``enabled``; :attr:`summary` is the
    reduction (``None`` when off).  Use :meth:`window` around the window."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.summary = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                yield
            if cuda:
                torch.cuda.synchronize()
        self.summary = reduce_profile(prof)
