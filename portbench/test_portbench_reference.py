"""The plain reference against the port's CPU path (the ``"torch"``
backend): argmin, top-k, bounds, counts and the front's index set, on
the 10,880-config reference grid and a small session grid.  The test
imports the port; the reference does not."""

import pytest

from portbench import cells, check, program, traffic
from portbench.reference import reduce

REFERENCE_GRID = {"cut": "all", "agg_node": ["7nm", "16nm"],
                  "sensor_node": ["7nm", "16nm"],
                  "weight_mem": ["sram", "mram"],
                  "detnet_fps": [5.0, 10.0, 15.0, 20.0, 30.0],
                  "keynet_fps": [15.0, 30.0], "num_cameras": [2.0, 4.0],
                  "mipi_energy_scale": [1.0, 2.0], "camera_fps": [30.0]}
SESSION_GRID = {"cut": [0, 11, 20], "sensor_node": ["7nm", "16nm"],
                "weight_mem": ["sram", "mram"],
                "detnet_fps": [5.0, 15.0, 30.0]}


def _against_reference(name, axes_spec):
    cell = (cells.assemble(*name) if isinstance(name, tuple)
            else cells.resolve(name))
    cfg = dict(cell.config, axes=dict(cell.config["axes"], **axes_spec))
    trf = dict(cell.traffic, chunk=4096)
    session = traffic.session(cfg, trf)
    axes = traffic.sweep_axes(cfg, 0, 0)
    prog = program.Program(cells.ROOT, cfg, trf, session, "cpu")
    got = prog.sweep(axes)
    grid = reduce.Grid(axes, session, "cpu")
    ref = reduce.sweep(grid, trf["objectives"], trf["maximize"],
                       trf["track"], trf["top_k"])
    return got, ref, check.numbers(got, ref, grid)


@pytest.mark.parametrize("name", [("dosc-ht-grid-1e8", "pareto3"),
                                  "grid-1e8.argmin"])
def test_reference_grid_agrees_with_the_port(name):
    got, ref, found = _against_reference(name, REFERENCE_GRID)
    assert got["n_total"] == 10_880
    assert found == {"count_err": 0, "index_mismatch": 0,
                     "value_rel_err": 0.0}
    assert list(got["front_idx"]) == list(ref["front_idx"])
    assert (got["topk_idx"] == ref["topk_idx"]).all()
    assert (got["min_idx"] == ref["min_idx"]).all()


@pytest.mark.parametrize("name", ["sessions-1m.long",
                                  "sessions-1m.default"])
def test_session_grid_agrees_with_the_port(name):
    spec = dict(SESSION_GRID, camera_fps=[30.0])
    got, ref, found = _against_reference(name, spec)
    assert got["n_total"] == 3 * 2 * 2 * 3 * 4
    assert found == {"count_err": 0, "index_mismatch": 0,
                     "value_rel_err": 0.0}
    assert list(got["front_idx"]) == list(ref["front_idx"])


def test_front_is_exact_on_ties():
    """Duplicates stay on the front; a point no better anywhere and worse
    in one column leaves it."""
    import torch
    V = torch.tensor([[1.0, 2.0], [1.0, 2.0], [2.0, 1.0], [2.0, 2.0],
                      [0.5, 3.0], [0.5, 3.5]], dtype=torch.float64)
    _, idx = reduce.pareto_front(V, torch.arange(6), block=2)
    assert sorted(idx.tolist()) == [0, 1, 2, 4]
