"""Share of the window in plan_stream (the harness's span a sweep)."""
from portbench.readers import percent_of_window


def read(ctx):
    return percent_of_window(ctx, "grid", lambda s: s["plan_s"])
