"""The session step's share of its roofline: the frozen float64
operations of the traced sweeps' pair-steps at the card's float64 peak,
over the device time of the chunk step's graph replays in the trace."""
from portbench.readers import bound_s, traced


def read(ctx):
    tr, b = traced(ctx, "sessions"), bound_s(ctx)
    if tr is None or b is None or not tr["graph_s"]:
        return None
    return 100.0 * b / tr["graph_s"]
