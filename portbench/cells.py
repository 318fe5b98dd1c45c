"""Cells, configurations, traffic mixes and metrics, found by name.

``BENCHMARK.json`` at the checkout's root names them.  A configuration
is the file its entry names (``file``); a traffic mix is
``portbench/traffic/<traffic>.json``; a metric, end-to-end or per-layer,
is ``portbench/metrics/<name>.py``, whose ``read(ctx)`` returns its value
or ``None`` where it finds nothing to read.  Adding a cell, a
configuration or a metric is adding such files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    rates: dict             # the frozen peak rates (portbench/h100.json)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its
    configuration, traffic mix and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    return assemble(w["config"], w["traffic"], root, name, int(w["chips"]))


def assemble(config: str, traffic: str, root: Path = ROOT,
             name: str | None = None, chips: int = 1) -> Cell:
    """The configuration ``config`` (by its ``BENCHMARK.json`` name) under
    the traffic mix ``traffic``, reporting the metrics of the cell
    ``name`` (none for a pair that is no cell)."""
    bench = load_json(root / "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}[config]
    e2e = [m for m in bench["end_to_end"] if name is not None and (
        "workloads" not in m or name in m["workloads"])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name is not None and _reports(m, name, names)]
    return Cell(name=name or f"{config}.{traffic}", chips=chips,
                config=load_json(root / entry["file"]),
                traffic=load_json(root / "portbench" / "traffic"
                                  / f"{traffic}.json"),
                end_to_end=e2e, per_layer=per_layer,
                rates=load_json(root / "portbench" / "h100.json"))


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict, root: Path = ROOT) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics whose readers found
    something to read."""
    out = {}
    for m in entries:
        v = reader(m["name"], root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
