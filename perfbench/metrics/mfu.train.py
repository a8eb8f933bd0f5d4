"""Model FLOPs of the window's training tokens (6*N*D plus causal
attention forward and backward, ``counts.model``) over the window's
seconds at the bf16 peak."""
from perfbench.metrics._common import mfu


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return mfu(ctx["lm"].train_flops(ctx["seq_len"], ctx["batch"]) * ctx["steps"],
               ctx["window_s"])
