"""Share of the traced window in which no operation ran on the device."""
from portbench.readers import traced


def read(ctx):
    tr = traced(ctx, "sessions")
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"]
                                             / tr["window_s"])
