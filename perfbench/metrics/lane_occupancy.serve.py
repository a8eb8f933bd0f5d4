"""Live lanes per pooled decode step over the window, as a share of the
pool: the differences of the scheduler's ``serve_occupancy`` sums at the
window's edges."""
from perfbench.metrics._common import diff


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    steps = diff(ctx["edges"], "occ_count")
    return None if steps <= 0 else 100.0 * diff(ctx["edges"], "occ_sum") / (steps * ctx["n_slots"])
