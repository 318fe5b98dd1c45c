"""The benchmark's files: cells resolve by name, a cell or metric is
added by files alone, nothing loads the JAX package, and the frozen
yardsticks agree with what they were taken from."""

import ast
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench import cells, run, small, traffic
from portbench.reference import opcount, rig

ROOT = cells.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m.get("workloads", CELLS), m["name"]
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A new traffic file, a new metric reader and new BENCHMARK.json
    entries make a new cell that runs, with no file of the benchmark
    edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads(json.dumps(BENCH))
    trf = json.loads((ROOT / "portbench/traffic/pareto3.json").read_text())
    trf.update(objectives=["avg_power", "latency"], top_k=2)
    (tmp_path / "portbench/traffic/pareto2.json").write_text(json.dumps(trf))
    (tmp_path / "portbench/metrics/front_size.grid.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx['sweeps'][0]['front_idx'].size)\n")
    bench["workloads"].append({"name": "grid-1e8.pareto2",
                               "config": "dosc-ht-grid-1e8",
                               "traffic": "pareto2", "chips": 1,
                               "why": "two objectives"})
    for m in bench["end_to_end"]:
        if m["name"] == "configs_per_s":
            m["workloads"].append("grid-1e8.pareto2")
    bench["end_to_end"].append(
        {"name": "front_size.grid", "unit": "configs", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["grid-1e8.pareto2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = small.small_cell("grid-1e8.pareto2", tmp_path)
    assert cell.traffic["objectives"] == ["avg_power", "latency"]
    out = run.run(cell, 2**31 + 7, 0.0, False, device="cpu", root=tmp_path)
    assert out["correct"]
    assert set(out["metrics"]) == {"configs_per_s", "setup_s",
                                   "front_size.grid"}


def _imports(path: Path) -> set:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f
    plain = list((ROOT / "portbench/reference").glob("*.py")) + [
        ROOT / "portbench/check.py", ROOT / "portbench/traffic.py"]
    for f in plain:
        assert "repro_torch" not in _imports(f), f


def test_frozen_work_counts_are_the_references():
    t = rig.rig_tables()
    nd, nk = int(t["det.n_layers"]), int(t["key.n_layers"])
    scalars = {k: v for k, v in t.items() if not isinstance(v, np.ndarray)}
    for name in ("grid-1e8.argmin", "sessions-1m.long"):
        cfg = cells.resolve(name).config
        sizes = {k: len(v) for k, v in traffic.sweep_axes(cfg, 0, 0).items()}
        if "session" not in cfg:
            for key, n in cfg["work"]["per_config"].items():
                assert opcount.config_ops(sizes, key.split("+"), nd, nk,
                                          scalars) == n
            continue
        for key, w in cfg["work"]["per_pair"].items():
            for steps in (1, 3):
                assert opcount.session_ops(
                    sizes, key.split("+"), nd, nk, scalars, cfg["session"],
                    steps) == w["pair"] + steps * w["pair_step"]


def test_frozen_rig_and_grids_are_the_programs():
    """The reference's copy of the rig gives the program's tables, and the
    configurations the program's published grids and session defaults."""
    import dataclasses

    from repro_torch.core import arrays, constants, grids, scenario
    ma = arrays.model_arrays()
    t = rig.rig_tables()
    for k, v in t.items():
        part, _, field = k.partition(".")
        src = getattr(getattr(ma, part), field) if field else getattr(ma, k)
        np.testing.assert_array_equal(np.asarray(src, np.float64), v)
    assert tuple(rig.NODES) == ma.node_names
    grid = cells.resolve("grid-1e8.argmin").config
    big = grids.stream_grid_axes(10**8)
    for axis, arg in (("detnet_fps", "detnet_fps"),
                      ("keynet_fps", "keynet_fps"),
                      ("camera_fps", "camera_fps")):
        d = grid["axes"][axis]
        assert (d["draw"], d["lo"], d["hi"]) == (
            len(big[arg]), min(big[arg]), max(big[arg]))
    for axis, arg in (("agg_node", "agg_nodes"),
                      ("sensor_node", "sensor_nodes"),
                      ("weight_mem", "weight_mems"),
                      ("num_cameras", "num_cameras"),
                      ("mipi_energy_scale", "mipi_energy_scale")):
        assert tuple(grid["axes"][axis]) == tuple(big[arg])
    assert traffic.n_points(grid) == grid["n_configs"] == 100_096_000
    sess = cells.resolve("sessions-1m.long").config
    for axis in ("detnet_fps", "camera_fps"):
        vals = grids.SCENARIO_BIG_GRID[axis]
        d = sess["axes"][axis]
        assert (d["draw"], d["lo"], d["hi"]) == (len(vals), min(vals),
                                                 max(vals))
    assert traffic.n_points(sess) == sess["n_configs"] == 1_018_368
    s = sess["session"]
    assert s["battery"] == dataclasses.asdict(constants.DEFAULT_BATTERY)
    assert s["thermal"] == dataclasses.asdict(constants.DEFAULT_THERMAL)
    assert s["traces"] == {n: [dataclasses.asdict(p) for p in t.phases]
                           for n, t in scenario.PROFILES.items()}


def test_draws_are_fresh_and_stratified():
    cfg = cells.resolve("grid-1e8.argmin").config
    a, b = (traffic.sweep_axes(cfg, 2**31 + 3, i) for i in (0, 1))
    for axis in ("detnet_fps", "keynet_fps", "camera_fps"):
        spec = cfg["axes"][axis]
        v = np.asarray(a[axis])
        edges = np.linspace(spec["lo"], spec["hi"], spec["draw"] + 1)
        assert ((v >= edges[:-1]) & (v < edges[1:])).all()
        assert not np.array_equal(v, b[axis])
    assert a == traffic.sweep_axes(cfg, 2**31 + 3, 0)
