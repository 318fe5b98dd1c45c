"""The program under test: ``repro_torch``'s ``stream_grid``, one call a
sweep.  The only module of the benchmark that imports the program; it
hands the program the generator's inputs and reads back what the sweep
delivers, its ``stats`` and the kernels' launch counters."""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import numpy as np

#: ``stream_grid``'s argument for each axis of the generator but the cut.
_ARGS = {"agg_node": "agg_nodes", "sensor_node": "sensor_nodes",
         "weight_mem": "weight_mems", "detnet_fps": "detnet_fps",
         "keynet_fps": "keynet_fps", "num_cameras": "num_cameras",
         "mipi_energy_scale": "mipi_energy_scale", "camera_fps": "camera_fps"}


def import_program(root: Path):
    """Put the checkout's ``src`` first on the path and import the
    stream entry; raises ImportError where the program is not there."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import stream
    return stream


class Program:
    """One configuration and traffic mix, driven on ``device``."""

    def __init__(self, root: Path, config: dict, traffic: dict, session,
                 device):
        self.stream = import_program(root)
        from repro_torch.core import constants, scenario
        from repro_torch.kernels.sweep_grid import kernel
        self.kernel, self.device = kernel, device
        self.config, self.traffic = config, traffic
        self.scenarios = None
        if session is not None:
            traces = tuple(
                scenario.ScenarioTrace(name, tuple(
                    scenario.Phase(**ph) for ph in phases))
                for name, phases in zip(config["axes"]["trace"],
                                        session["traces"]))
            self.scenarios = scenario.ScenarioSet(
                traces=traces,
                battery=constants.BatterySpec(**session["battery"]),
                thermal=constants.ThermalSpec(**session["thermal"]),
                steps_per_phase=session["steps_per_phase"])

    def _kwargs(self, axes: dict) -> dict:
        kw = {"cuts": None if self.config["axes"]["cut"] == "all"
              else tuple(axes["cut"])}
        kw.update((arg, tuple(axes[name]))
                  for name, arg in _ARGS.items())
        t = self.traffic
        return dict(kw, scenarios=self.scenarios, chunk_size=t["chunk"],
                    top_k=t["top_k"], objectives=tuple(t["objectives"]),
                    maximize=tuple(t["maximize"]), track=tuple(t["track"]),
                    scan_chunks=t["scan_chunks"], device=self.device)

    def sweep(self, axes: dict, span=None) -> dict:
        """One sweep of ``axes``: plan it, stream it, and return what it
        delivered (numpy, in the reference's layout), its ``stats``, the
        seconds planning took and the plan's chunks a dispatch."""
        ctx = span or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx("portbench.plan_stream"):
            plan = self.stream.plan_stream(**self._kwargs(axes))
        plan_s = time.perf_counter() - t0
        with ctx("portbench.stream_grid"):
            res = self.stream.stream_grid(plan=plan,
                                          prefetch=self.traffic["prefetch"])
        fields = list(plan.fields)
        order = np.argsort(res.front_indices, kind="stable")
        return {
            "fields": fields,
            "min_val": np.array([res.min_val[f] for f in fields]),
            "min_idx": np.array([res.min_idx[f] for f in fields]),
            "finite": np.array([res.finite_counts[f] for f in fields]),
            "fmin": np.array([res.channel_min[f] for f in fields]),
            "fmax": np.array([res.channel_max[f] for f in fields]),
            "topk_val": np.asarray(res.topk_val, np.float64),
            "topk_idx": np.asarray(res.topk_idx, np.int64),
            "front_idx": np.asarray(res.front_indices, np.int64)[order],
            "front_val": np.asarray(res.front_values, np.float64)[order],
            "n_total": res.n_configs, "stats": dict(res.stats),
            "plan_s": plan_s, "scan": plan.scan, "backend": res.backend,
        }

    def launches(self) -> dict:
        """Launch counters of kernels A (chunk step, graph replays
        included) and B (dense evaluation)."""
        return {"A": self.kernel.sweep_grid_chunk.launches,
                "B": self.kernel.sweep_grid_eval.launches}
