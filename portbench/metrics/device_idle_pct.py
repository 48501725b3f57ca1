"""The share of the traced window in which the card ran nothing: 1 minus
the union of its kernels, copies and sets over the window (the mean over
the cards of a cell across processes)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
