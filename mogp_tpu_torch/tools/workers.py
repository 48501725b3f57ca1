"""Start the processes of one multi-process run and wait for them, within a
deadline.

``init_distributed`` joins processes that a launcher has started, as
``torchrun`` does.  :func:`run_workers` is the small launcher of this
repository's own multi-process runs (``chip_smoke.py``'s phase 11,
``tools/mesh_cards.py --processes`` and ``tests/test_torch_distributed.py``):
it gives the workers a free port on this host for process 0 to listen on,
and makes a failure fail the run instead of hanging it.  A process that
raises leaves its peers waiting in a collective, so the first worker that
exits with another code than 0, or the deadline, ends every worker, and
:func:`run_workers` raises with each worker's output.
"""

import socket
import subprocess
import tempfile
import time

__all__ = ["WorkersFailed", "free_port", "run_workers"]


class WorkersFailed(RuntimeError):
    """A worker failed or the deadline passed; ``outputs`` holds each
    worker's ``(returncode, output)`` (``None`` for a worker that was
    killed)."""

    def __init__(self, message, outputs):
        super().__init__(message + "".join(
            "\n--- worker {} (exit {}) ---\n{}".format(k, rc, out)
            for k, (rc, out) in enumerate(outputs)))
        self.outputs = outputs


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
        killed = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outputs = []
    for p, f, k in zip(procs, files, killed):
        f.seek(0)
        outputs.append((None if k else p.returncode, f.read().decode(errors="replace")))
        f.close()
    if why is None and any(rc != 0 for rc, _ in outputs):
        k = next(k for k, (rc, _) in enumerate(outputs) if rc != 0)
        why = "worker {} exited with {}".format(k, outputs[k][0])
    return why, outputs


def run_workers(make_argvs, deadline, env=None, cwd=None):
    """Run one process per command of ``make_argvs(port)`` (``port`` a free
    port of this host, for ``init_distributed("localhost:{port}", ...)``)
    and wait for all of them.

    :param deadline: seconds the run may take.
    :returns: each worker's output (stdout and stderr), in order, when
        every worker exited with 0.
    :raises WorkersFailed: at the first worker to exit with another code,
        or at the deadline, after killing the others.  A port taken
        between its choice and process 0's bind is chosen again, once.
    """
    for attempt in range(2):
        why, outputs = _run_once(make_argvs(free_port()), deadline, env, cwd)
        if why is None:
            return [out for _, out in outputs]
        if attempt == 0 and _port_taken(outputs):
            continue
        raise WorkersFailed(why, outputs)
