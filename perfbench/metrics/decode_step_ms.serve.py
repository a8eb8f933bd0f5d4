"""The pooled decode step's mean host time over the window (it ends in the
step's token read): differences of the scheduler's ``decode_ms_total``
and ``decode_steps`` at the window's edges."""
from perfbench.metrics._common import diff


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    steps = diff(ctx["edges"], "decode_steps")
    return None if steps <= 0 else diff(ctx["edges"], "decode_ms_total") / steps
