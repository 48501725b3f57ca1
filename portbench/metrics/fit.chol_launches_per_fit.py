"""Cholesky launches a fit makes: ``ops.cholesky_batched.launches`` (K2)
plus every variant of ``ops.cholesky_blocked.launches`` (K3-K5), reset
before each fit and read after it, averaged over the window's fits.  A
count of calls, not of matrices factored; it repeats exactly on a seed."""


def read(run):
    if not run.records:
        return None
    return sum(r["launches"] for r in run.records) / len(run.records)
