"""The grouped sum-of-squares kernels' share of their roofline over the
traced steps: one forward and one backward launch a step over every
plane of wp and wn (``counts.bgl_sumsq``), over their device time.
Nothing where the launches are not one of each a step."""
from perfbench.counts import bgl_sumsq
from perfbench.metrics._common import BGL_BWD, BGL_FWD, traced


def read(ctx):
    s = traced(ctx, "train")
    if s is None:
        return None
    steps = ctx["profile_steps"]
    t_f, n_f = s.time_of(lambda name: BGL_FWD.search(name) is not None)
    t_b, n_b = s.time_of(lambda name: BGL_BWD.search(name) is not None)
    if n_f != steps or n_b != steps:
        return None
    el, rows = ctx["bgl_elements"], ctx["bgl_rows"]
    least = steps * (bgl_sumsq.least(el, rows) + bgl_sumsq.least(el, rows, backward=True))
    return 100.0 * least / (t_f + t_b)
