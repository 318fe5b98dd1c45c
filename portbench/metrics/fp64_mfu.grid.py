"""The window's frozen float64 operations over the traced window at the
card's float64 peak."""
from portbench.readers import bound_s, traced


def read(ctx):
    tr, b = traced(ctx, "grid"), bound_s(ctx)
    return None if tr is None or b is None else 100.0 * b / tr["window_s"]
