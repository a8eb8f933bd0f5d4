"""The share of the traced training steps in which no device activity ran."""
from perfbench.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx, "train")
