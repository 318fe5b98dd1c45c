"""The port's streaming executor on the CPU against the JAX reference's
``stream_grid`` and its dense front on the 10,880-config grid: argmin,
top-k, counts and bounds of every tracked channel, histograms, and the
exact Pareto-front index set — with and without constraints, with a
maximized objective, at non-dividing chunk sizes, and through a forced
survivor overflow."""

import numpy as np
import pytest

from _jax_reference import assert_close, run
from repro_torch.core import pareto, stream, sweep
from repro_torch.core.grids import REFERENCE_GRID

LATENCY_BUDGET = 0.0283   # about the 40th percentile of the grid
RUNS = {
    "c997_all": dict(chunk_size=997, top_k=4, track="all"),
    "c997_cons": dict(chunk_size=997, constraints={"latency":
                                                   LATENCY_BUDGET}),
    "c4096_max_hist": dict(chunk_size=4096,
                           objectives=("avg_power", "sensor_macs_per_s"),
                           maximize=("sensor_macs_per_s",), hist_bins=16),
}


@pytest.fixture(scope="module")
def ref():
    return run("stream", grid=REFERENCE_GRID, runs=RUNS)


@pytest.fixture(scope="module")
def ours():
    return {name: stream.stream_grid(**REFERENCE_GRID, **kw, device="cpu")
            for name, kw in RUNS.items()}


@pytest.fixture(scope="module")
def dense():
    return sweep.evaluate_grid(**REFERENCE_GRID, device="cpu")


def _same_config(got: dict, want: dict, field: str):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == field:
            assert_close(got[k], v, what=field)
        else:
            assert got[k] == v, (field, k)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_argmin_counts_and_bounds(ours, ref, name):
    res, want = ours[name], ref["runs"][name]
    assert res.min_idx == want["min_idx"]
    assert res.finite_counts == want["finite"]
    for f, (lo, hi) in want["bounds"].items():
        assert_close(res.channel_bounds(f) if res.finite_counts[f]
                     else (res.channel_min[f], res.channel_max[f]),
                     (lo, hi), what=f)
        assert_close(res.min_val[f], want["min_val"][f], what=f)
    for f, cfg in want["argmin"].items():
        _same_config(res.argmin(f), cfg, f)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_top_k(ours, ref, name):
    res, want = ours[name], ref["runs"][name]
    assert np.array_equal(res.topk_idx, want["topk_idx"])
    assert_close(res.topk_val, want["topk_val"], what="topk")
    for o in res.objectives:
        got, exp = res.top_k(o), want["top_k"][o]
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            _same_config(g, e, o)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pareto_front_index_set(ours, ref, name):
    front = ours[name].pareto_front()
    want_i, want_v = ref["runs"][name]["front_idx"], \
        ref["runs"][name]["front_val"]
    assert np.array_equal(front.indices, want_i)
    assert_close(front.values, want_v, what="front")
    dense_i, _ = ref["dense_front"][name]
    assert np.array_equal(front.indices, dense_i)


def test_histograms(ours, ref):
    res, want = ours["c4096_max_hist"], ref["runs"]["c4096_max_hist"]
    assert res.hist.keys() == want["hist"].keys()
    for f, (counts, edges) in res.hist.items():
        assert np.array_equal(counts, want["hist"][f]), f
        assert counts.sum() == res.finite_counts[f]


def test_stream_equals_own_dense_path(ours, dense):
    res = ours["c997_all"]
    for f in sweep.FIELDS:
        assert res.argmin(f) == dense.argmin(f), f
        assert res.channel_bounds(f) == dense.channel_bounds(f), f
    for o in res.objectives:
        assert res.top_k(o) == dense.top_k(o, 4)
    front = pareto.pareto_front(dense)
    assert np.array_equal(res.pareto_front().indices, front.indices)
    assert np.array_equal(res.pareto_front().values, front.values)


def test_constrained_front_equals_constrained_dense(ours, dense):
    dc = dense.constrain({"latency": LATENCY_BUDGET})
    res = ours["c997_cons"]
    assert res.argmin() == dc.argmin()
    assert np.array_equal(res.pareto_front().indices,
                          pareto.pareto_front(dc).indices)


def test_survivor_overflow_falls_back_exactly(monkeypatch, ref):
    """A survivor-capacity overflow re-derives the chunk's survivors
    through the dense evaluator instead of truncating the front."""
    monkeypatch.setattr(stream, "_SURVIVOR_CAP", 8)
    res = stream.stream_grid(**REFERENCE_GRID, chunk_size=2048,
                             device="cpu")
    assert res.stats["fallback_chunks"] > 0
    want_i, want_v = ref["dense_front"]["c997_all"]
    front = res.pareto_front()
    assert np.array_equal(front.indices, want_i)
    assert_close(front.values, want_v, what="front")


def test_all_infeasible_reports_constraints():
    res = stream.stream_grid(cuts=(0, 1), constraints={"latency": 0.0},
                             device="cpu")
    assert res.finite_counts["avg_power"] == 0
    with pytest.raises(ValueError, match="feasible"):
        res.argmin()
