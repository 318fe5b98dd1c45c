"""Eq. 1-11 and the dense engine of the port against the JAX reference:
all eleven channels on the 10,880-config grid and on a stacked models=
axis, the flat-index decode beyond 2^31, and constraints."""

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, run
from repro_torch.core import sweep
from repro_torch.core.grids import REFERENCE_GRID
from repro_torch.core.handtracking import build_detnet, build_keynet

BIG_SHAPE = (10,) * 10          # 10^10 configs — far beyond int32
BIG_FLAT = [0, 2**31 - 1, 2**31, 2**33 + 12345, 10**10 - 1]
CONSTRAINTS = {
    "mapping": {"latency": 0.03},
    "mapping_op": {"mipi_bytes_per_s": [">=", 2.5e5]},
    "strings": ["latency <= 3e-2", "avg_power > 1e-3"],
    "tuples": [["agg_memory", "<", 0.5]],
}


@pytest.fixture(scope="module")
def dense():
    return sweep.evaluate_grid(**REFERENCE_GRID, device="cpu")


@pytest.fixture(scope="module")
def budget(dense):
    return {"latency": float(np.nanquantile(dense.data["latency"], 0.4))}


@pytest.fixture(scope="module")
def ref(budget):
    return run("sweep", grid=REFERENCE_GRID, constraints=CONSTRAINTS,
               budget=budget, big_shape=BIG_SHAPE, big_flat=BIG_FLAT)


@pytest.fixture(scope="module")
def stacked():
    det, key = build_detnet(), build_keynet()
    return sweep.evaluate_grid(models=((det, key), (det.scaled(0.5), key)),
                               detnet_fps=(10.0, 30.0), device="cpu")


def _same_argmin(got: dict, want: dict, field: str):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == field:
            assert_close(got[k], v, what=field)
        else:
            assert got[k] == v, (field, k)


@pytest.mark.parametrize("field", sweep.FIELDS)
def test_field_matches_reference(dense, ref, field):
    assert dense.shape == tuple(ref["shape"])
    assert_close(dense.data[field], ref["dense"][field], what=field)


def test_argmin_every_field(dense, ref):
    for f in sweep.FIELDS:
        _same_argmin(dense.argmin(f), ref["argmin"][f], f)


@pytest.mark.parametrize("field", sweep.FIELDS)
def test_stacked_models_axis(stacked, ref, field):
    assert stacked.shape[0] == 2 and "model" in stacked.axes
    assert_close(stacked.data[field], ref["stacked"][field], what=field)
    _same_argmin(stacked.argmin(field), ref["stacked_argmin"][field], field)


def test_decode_beyond_int32_matches_reference(ref):
    flat = np.asarray(BIG_FLAT, np.int64)
    want = np.unravel_index(flat, BIG_SHAPE)
    ours = sweep.decode_flat_index(BIG_SHAPE, flat)
    on_device = sweep.decode_flat_index(BIG_SHAPE, torch.as_tensor(flat))
    for a, t, r, u in zip(ours, on_device, ref["decode"], want):
        assert np.array_equal(a, r) and np.array_equal(a, u)
        assert np.array_equal(t.numpy(), u)
    assert sweep.decode_flat_index(BIG_SHAPE, 10**10 - 1) == (9,) * 10


def test_narrow_index_is_promoted():
    flat32 = torch.tensor([7, 2**31 - 1], dtype=torch.int32)
    coords = sweep.decode_flat_index(BIG_SHAPE, flat32)
    want = np.unravel_index(flat32.numpy().astype(np.int64), BIG_SHAPE)
    for c, w in zip(coords, want):
        assert c.dtype == torch.int64 and np.array_equal(c.numpy(), w)
    np32 = sweep.decode_flat_index(BIG_SHAPE, flat32.numpy())
    assert all(c.dtype == np.int64 for c in np32)


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_parse_constraints_matches_reference(ref, name):
    assert sweep.parse_constraints(CONSTRAINTS[name]) == \
        tuple(tuple(c) for c in ref["parsed"][name])


def test_constraint_errors():
    with pytest.raises(ValueError, match="unknown constraint channel"):
        sweep.parse_constraints({"watts": 1.0})
    with pytest.raises(ValueError, match="cannot parse"):
        sweep.parse_constraints(["latency ~ 3"])
    with pytest.raises(ValueError, match="op"):
        sweep.parse_constraints([("latency", "==", 1.0)])


def test_constrain_masks_like_reference(dense, ref, budget):
    masked = dense.constrain(budget)
    for f in sweep.FIELDS:
        assert_close(masked.data[f], ref["constrained"][f], what=f)
    mask = sweep.constraint_mask(dense.data, budget)
    assert np.array_equal(np.isfinite(masked.data["avg_power"]),
                          mask & np.isfinite(dense.data["avg_power"]))


def test_float64_without_touching_the_global_default(dense):
    assert torch.get_default_dtype() == torch.float32
    assert all(a.dtype == np.float64 for a in dense.data.values())


def test_index_axes_are_validated():
    with pytest.raises(ValueError, match="cuts outside"):
        sweep.build_axes(cuts=(0, 34))
    with pytest.raises(KeyError, match="unknown tech node"):
        sweep.build_axes(agg_nodes=("5nm",))
    with pytest.raises(ValueError, match="unknown weight_mem"):
        sweep.build_axes(weight_mems=("dram",))
