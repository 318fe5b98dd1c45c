"""Configurations of every sweep of the window over its seconds."""
from portbench.readers import rate


def read(ctx):
    return rate(ctx, "grid")
