"""The share of the traced serving slice in which no device activity ran."""
from perfbench.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx, "serve")
