"""The parity anchors frozen in ``repro_torch.core.grids`` are what the
JAX reference computes, recomputed here on the CPU: its ``stream_grid``
over the 10,009,600-config grid (default objectives, top-4), its dense
``evaluate_grid`` over the 1,000,960-config grid (``ANCHOR_1M``), its
pricing of the hand-tracking pipeline (``PRICING_ANCHOR``) and its knob
optimizer on ``examples/partition_study.py``'s search
(``ANCHOR_OPTIMIZE``).  The port's plain path on the CPU is held to
``ANCHOR_1M`` too (the card is, in ``chip_smoke.py``)."""

import numpy as np
import pytest

from _jax_reference import assert_close, run
from repro_torch.core import pareto, sweep
from repro_torch.core.grids import (ANCHOR_1M, ANCHOR_10M, ANCHOR_OPTIMIZE,
                                    OPTIMIZE_SEARCH, PRICING_ANCHOR,
                                    dense_summary, index_hash,
                                    stream_grid_axes, top_k_flat)


def test_anchor_10m_matches_reference():
    grid = stream_grid_axes(10_000_000)
    ref = run("anchor", grid=grid)
    assert ref["n_configs"] == ANCHOR_10M["n_configs"]
    assert ref["argmin_idx"] == ANCHOR_10M["argmin_idx"]
    assert ref["best_avg_power"] == ANCHOR_10M["best_avg_power"]
    assert np.array_equal(ref["topk_idx"], ANCHOR_10M["topk_idx"])
    assert ref["finite"] == ANCHOR_10M["finite"]
    assert ref["front_idx"].size == ANCHOR_10M["front_size"]
    assert index_hash(ref["front_idx"]) == ANCHOR_10M["front_hash"]


def test_pricing_anchor_matches_reference():
    ref = run("scalar", systems={})
    assert ref["pricing"] == PRICING_ANCHOR


def test_anchor_optimize_is_what_jax_computes():
    s = OPTIMIZE_SEARCH
    bounds = {k: list(b) for k, b in s["bounds"].items()}
    ref = run("optimize",
              points=[[s["objective"], None, s["config"]]],
              searches={"s": [bounds, s["objective"],
                              dict(s["config"], steps=s["steps"])]},
              grids={"g": [bounds, s["objective"],
                           dict(s["config"], n=s["n"])]},
              errors={})
    a = ANCHOR_OPTIMIZE
    point = ref["points"][0]
    assert point["value"] == a["gradient_value"]
    assert point["grad"] == a["gradient"]
    search = ref["searches"]["s"]
    assert search["knobs"] == a["knobs"]
    assert search["objective"] == a["objective"]
    assert search["trajectory"].tolist() == list(a["trajectory"])
    assert ref["grids"]["g"] == (a["grid_knobs"], a["grid_value"])


@pytest.fixture(scope="module")
def dense_1m():
    return run("dense", grid=stream_grid_axes(10**6))


def test_anchor_1m_is_what_jax_computes(dense_1m):
    assert dense_summary(dense_1m["data"], dense_1m["front_idx"]) == ANCHOR_1M
    assert list(ANCHOR_1M["argmin_idx"]) == list(sweep.FIELDS)


def test_plain_dense_path_matches_anchor_1m(dense_1m):
    """The port's ``evaluate_grid`` on the CPU over the 1,000,960-config
    grid: every channel within 1e-12 of the reference's (NaN pattern
    equal), and the frozen anchor read from it."""
    res = sweep.evaluate_grid(**stream_grid_axes(10**6), device="cpu")
    assert res.n_configs == ANCHOR_1M["n_configs"] < 1 << 20
    for f in sweep.FIELDS:
        assert_close(res.data[f].ravel(), dense_1m["data"][f], what=f)
    got = dense_summary(res.data, pareto.pareto_front(res).indices)
    assert got == ANCHOR_1M


def test_top_k_flat_is_sweep_results_order():
    v = np.array([3.0, np.nan, 1.0, 1.0, np.inf, 0.5, 3.0])
    assert top_k_flat(v, 4) == (5, 2, 3, 0)
    assert top_k_flat(v, 10) == (5, 2, 3, 0, 6)
    res = sweep.evaluate_grid(device="cpu")
    for f in sweep.FIELDS:
        flat = res.data[f].ravel()
        want = res.top_k(f, 4)
        got = top_k_flat(flat)
        assert len(got) == len(want)
        for i, cfg in zip(got, want):
            assert {**res.config_at(i), f: float(flat[i])} == cfg
