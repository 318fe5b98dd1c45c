"""Set-up seconds: process start to the first timed sweep (imports, the
kernels' build or load, lowering, one warm sweep of the cell's shapes)."""


def read(ctx):
    return ctx["setup_s"]
