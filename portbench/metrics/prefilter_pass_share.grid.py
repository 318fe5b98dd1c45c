"""Share of the configurations swept whose rows pass the chunk step's
constraint mask and dominance pre-filter and reach the host (stream_grid's
own stats["survivors"] over stats["n_configs"], summed over the window's
sweeps).  Nothing where the program does not count them."""


def read(ctx):
    sweeps = ctx["sweeps"]
    if (ctx["kind"] != "grid" or not sweeps
            or not all("survivors" in s["stats"] for s in sweeps)):
        return None
    return (100.0 * sum(s["stats"]["survivors"] for s in sweeps)
            / sum(s["stats"]["n_configs"] for s in sweeps))
