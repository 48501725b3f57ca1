"""A plain reference that ``tiny.plug_tree`` lays into a benchmark tree of
its own as ``reference/plug_ref.py``: the default reference's interface
under another name, each call marked on standard error so that a test sees
the harness reach it."""

import sys

from reference import gp_ref


def _marked(name):
    def call(*args, **kw):
        print("plug_ref." + name, file=sys.stderr)
        return getattr(gp_ref, name)(*args, **kw)

    return call


priors = _marked("priors")
restart_points = _marked("restart_points")
seeded_raw = _marked("seeded_raw")
judge = _marked("judge")
own_fit = _marked("own_fit")
polish = _marked("polish")
implausibility = _marked("implausibility")
