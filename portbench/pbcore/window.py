"""The measured window of a closed loop.

One request after another, each ending with its results on the host.  The
window opens at the start of the first request and closes at the end of
the first request that ends ``seconds`` or more after it opened: no
partial request, and no request left out of the rate.
"""

import time


def closed_loop(request, seconds, agree=None, clock=time.perf_counter):
    """Run ``request(k)`` for ``k = 0, 1, ...`` back to back.

    :param agree: where several processes run the loop together, a
        function that takes this process's "go on" and returns the one that
        every process follows (process 0's), so that all run the same
        requests.
    :returns: ``(requests run, window seconds)``.
    """
    t0 = clock()
    k = 0
    while True:
        request(k)
        k += 1
        elapsed = clock() - t0
        go_on = elapsed < seconds
        if agree is not None:
            go_on = agree(go_on)
        if not go_on:
            return k, elapsed
