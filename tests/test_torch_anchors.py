"""The parity anchors frozen in ``repro_torch.core.grids`` are what the
JAX reference computes, recomputed here on the CPU: its ``stream_grid``
over the 10,009,600-config grid (default objectives, top-4), and its
pricing of the hand-tracking pipeline (``PRICING_ANCHOR``)."""

import numpy as np

from _jax_reference import run
from repro_torch.core.grids import (ANCHOR_10M, PRICING_ANCHOR, index_hash,
                                    stream_grid_axes)


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
