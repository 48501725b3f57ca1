"""Several processes, one card each, joined by ``init_distributed``.

:func:`run_workers` is a copy of ``mogp_tpu_torch/tools/workers.py``'s
launcher: a free TCP port of ``localhost`` for process 0 to listen on, and
the first worker that fails, or the deadline, ends every worker, so that a
failure fails the run instead of hanging it.  Every worker is waited for.
"""

import socket
import subprocess
import tempfile
import time


class WorkersFailed(RuntimeError):
    """A worker failed or the deadline passed; the message holds each
    worker's output."""


def free_port():
    """A TCP port of ``localhost`` that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _port_taken(outputs):
    return any("EADDRINUSE" in out or "ddress already in use" in out for _, out in outputs)


def _run_once(argvs, deadline, env, cwd):
    files = [tempfile.TemporaryFile() for _ in argvs]
    procs = [subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT, env=env, cwd=cwd)
             for argv, f in zip(argvs, files)]
    end = time.monotonic() + deadline
    why = None
    try:
        while why is None and any(p.poll() is None for p in procs):
            failed = [k for k, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                why = "worker {} exited with {}".format(failed[0], procs[failed[0]].returncode)
            elif time.monotonic() > end:
                why = "the workers outlasted their deadline of {} s".format(deadline)
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outputs = []
    for p, f in zip(procs, files):
        f.seek(0)
        outputs.append((p.returncode, f.read().decode(errors="replace")))
        f.close()
    if why is None and any(rc != 0 for rc, _ in outputs):
        k = next(k for k, (rc, _) in enumerate(outputs) if rc != 0)
        why = "worker {} exited with {}".format(k, outputs[k][0])
    return why, outputs


def run_workers(make_argvs, deadline, env=None, cwd=None):
    """Run one process per command of ``make_argvs(port)`` and wait for all
    of them; returns their outputs.  A port taken between its choice and
    process 0's bind is chosen again, once."""
    for attempt in range(2):
        why, outputs = _run_once(make_argvs(free_port()), deadline, env, cwd)
        if why is None:
            return [out for _, out in outputs]
        if attempt == 0 and _port_taken(outputs):
            continue
        raise WorkersFailed(why + "".join(
            "\n--- worker {} (exit {}) ---\n{}".format(k, rc, out[-4000:])
            for k, (rc, out) in enumerate(outputs)))
