"""The one traffic generator: a sweep's inputs from the cell's files and
the seed.

A configuration file fixes the grid: each axis is a list of values, or
``{"draw": n, "lo": a, "hi": b}``, a rate axis whose ``n`` values every
sweep draws afresh, one uniformly inside each of ``n`` equal strata of
``[a, b)``, so that every sweep has the same sizes and spread and no two
sweeps the same values.  ``"cut": "all"`` is every partition cut of the
rig.  A session configuration adds its traces, battery and thermal node
(``session``); the traffic file adds ``steps_per_phase``.
"""

from __future__ import annotations

import numpy as np

from .reference import rig as R

#: Grid axes in the order of the flat index (C order), the trace last.
AXES = ("cut", "agg_node", "sensor_node", "weight_mem", "detnet_fps",
        "keynet_fps", "num_cameras", "mipi_energy_scale", "camera_fps",
        "trace")


def rng(seed: int, index: int) -> np.random.Generator:
    """The generator of sweep ``index`` of a run under ``seed`` (``-1``:
    the set-up's warm sweep; ``-2``: the draw of the sweeps checked)."""
    return np.random.default_rng([int(seed) % 2**64, int(index) + 2])


def sweep_axes(config: dict, seed: int, index: int) -> dict:
    """The axes of one sweep, in :data:`AXES` order: names for the node,
    memory and trace axes, numbers for the rest."""
    g = rng(seed, index)
    out = {}
    for name in AXES:
        spec = config["axes"].get(name)
        if spec is None:
            continue
        if spec == "all":
            out[name] = list(range(R.n_cuts()))
        elif isinstance(spec, dict):
            n, lo, hi = int(spec["draw"]), float(spec["lo"]), float(spec["hi"])
            u = g.random(n)
            out[name] = [float(v) for v in
                         lo + (hi - lo) * (np.arange(n) + u) / n]
        else:
            out[name] = list(spec)
    return out


def n_points(config: dict) -> int:
    """Points (configurations, or pairs) of one sweep."""
    return int(np.prod([len(v) for v in sweep_axes(config, 0, 0).values()]))


def session(config: dict, traffic: dict) -> dict | None:
    """The session model of a sweep: battery, thermal node, the traces'
    phases in the order of the ``trace`` axis, and the steps a phase."""
    if "session" not in config:
        return None
    s = config["session"]
    return {"battery": s["battery"], "thermal": s["thermal"],
            "traces": [s["traces"][t] for t in config["axes"]["trace"]],
            "steps_per_phase": int(traffic["steps_per_phase"])}


def pair_steps(config: dict, traffic: dict) -> int:
    """The (configuration x trace) steps of one sweep that advance time:
    each trace's phases times the steps a phase, over every
    configuration (steps that pad a shorter trace are left out)."""
    sess = session(config, traffic)
    n_traces = len(sess["traces"])
    per_trace = n_points(config) // n_traces
    return per_trace * sum(len(p) * sess["steps_per_phase"]
                           for p in sess["traces"])
