"""Device microseconds a chunk's fold takes in the chunk step's graph: the
traced window's device time of the graph replays less kernel A's, over
the chunks those replays folded (each traced sweep's graph replays times
its chunks a replay).  The fold is fold_chunk's torch ops, or the cuda
backend's fold kernel where the program has one."""
from portbench.readers import traced


def read(ctx):
    tr = traced(ctx, "grid")
    if tr is None or not tr["a_s"]:
        return None
    chunks = sum(s["stats"]["graph_replays"] * s["scan"]
                 for s in ctx["sweeps"])
    return 1e6 * (tr["graph_s"] - tr["a_s"]) / chunks if chunks else None
