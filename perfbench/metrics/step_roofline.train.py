"""The least time of one BSQ step (the plane state and its momentum read
and written once at the HBM rate, or the step's FLOPs at the bf16 peak,
whichever is larger) over the window's mean step time."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    least = ctx["lm"].bsq_step_least(int(ctx["bsq"]["n_max"]), ctx["seq_len"], ctx["batch"])
    return 100.0 * least / (ctx["window_s"] / ctx["steps"])
