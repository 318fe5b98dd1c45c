"""Share of the window in host merges and survivor handling
(stream_grid's own stats["host_merge_s"])."""
from portbench.readers import percent_of_window


def read(ctx):
    return percent_of_window(ctx, "sessions",
                             lambda s: s["stats"]["host_merge_s"])
