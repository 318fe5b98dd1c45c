"""Share of the window blocked on a dispatch's survivors (stream_grid's
own stats["device_wait_s"]: the chunk step's device work that the host
did not hide, and the copy)."""
from portbench.readers import percent_of_window


def read(ctx):
    return percent_of_window(ctx, "grid",
                             lambda s: s["stats"]["device_wait_s"])
