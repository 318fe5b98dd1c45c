"""Share of the window spent issuing dispatches (stream_grid's own
stats["dispatch_s"]: writing the start, replaying the graph, queueing
the copies)."""
from portbench.readers import percent_of_window


def read(ctx):
    return percent_of_window(ctx, "grid", lambda s: s["stats"]["dispatch_s"])
