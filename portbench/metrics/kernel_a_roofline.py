"""Kernel A's share of its roofline: the frozen float64 operations of
the traced sweeps' configurations at the card's float64 peak, over A's
device time in the trace."""
from portbench.readers import bound_s, traced


def read(ctx):
    tr, b = traced(ctx, "grid"), bound_s(ctx)
    if tr is None or b is None or not tr["a_s"]:
        return None
    return 100.0 * b / tr["a_s"]
