"""Share of the window in the strided probe before a sweep's first
dispatch (stream_grid's own stats["probe_s"]; on a session sweep an
eager session_eval over its probe points).  Nothing where the program
does not time it."""
from portbench.readers import percent_of_window


def read(ctx):
    if not all("probe_s" in s["stats"] for s in ctx["sweeps"]):
        return None
    return percent_of_window(ctx, "sessions",
                             lambda s: s["stats"]["probe_s"])
