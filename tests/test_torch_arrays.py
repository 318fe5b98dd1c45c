"""The port's copies of the model tables equal the reference's exactly,
and reference tables carry over into the port (``tables_from_numpy``)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from _jax_reference import run
from repro_torch.core import arrays as A
from repro_torch.core.handtracking import build_detnet, build_keynet


@pytest.fixture(scope="module")
def ref():
    return run("arrays")


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        elif isinstance(v, (tuple, int, float, str)):
            out[prefix + f.name] = v
    return out


def _port_tables():
    det, key = build_detnet(), build_keynet()
    return {
        "model": A.model_arrays(),
        "stack": A.stack_model_arrays((A.model_arrays(),)),
        "stacked2": A.stacked_model_arrays(((det, key),
                                            (det.scaled(0.5), key))),
    }


def _assert_same(port: dict, want: dict):
    assert port.keys() == want.keys()
    for name, v in want.items():
        if isinstance(v, np.ndarray):
            assert port[name].dtype == v.dtype, name
            assert np.array_equal(port[name], v, equal_nan=True), name
        else:
            assert port[name] == v, name


@pytest.mark.parametrize("which", ["model", "stack", "stacked2"])
def test_tables_equal_reference(ref, which):
    _assert_same(_fields(_port_tables()[which]), ref[which])


def _namespace(flat: dict):
    """A duck-typed stand-in for the reference's stacked tables, built
    from its field values (nested ``det``/``key`` included)."""
    top, sub = {}, {"det": {}, "key": {}}
    for name, v in flat.items():
        head, _, rest = name.partition(".")
        if rest:
            sub[head][rest] = v
        else:
            top[name] = v
    return types.SimpleNamespace(
        **top, det=types.SimpleNamespace(**sub["det"]),
        key=types.SimpleNamespace(**sub["key"]))


@pytest.mark.parametrize("which", ["stack", "stacked2"])
def test_tables_from_numpy_carries_reference_stack(ref, which):
    S = A.tables_from_numpy(_namespace(ref[which]))
    assert isinstance(S, A.StackedModelArrays)
    _assert_same(_fields(S), ref[which])


def test_tables_to_device_packs_every_array(ref):
    S = _port_tables()["stacked2"]
    T = A.tables_to_device(S, "cpu")
    arrays = {k: v for k, v in _fields(S).items()
              if isinstance(v, np.ndarray)}
    assert set(T.names) == set(arrays)
    assert T.buf.dtype == torch.float64
    assert T.buf.is_contiguous() and T.buf.dim() == 1
    meta = T.meta.numpy()
    assert meta.shape == (len(arrays), 3)
    for row, name in zip(meta, T.names):
        a = arrays[name]
        off, rows, cols = row
        assert (rows, cols) == (a.shape[0], a.shape[1] if a.ndim == 2 else 1)
        assert np.array_equal(T.buf[off:off + a.size].numpy(),
                              a.astype(np.float64).ravel(), equal_nan=True)
        assert np.array_equal(T[name].numpy(), a.astype(np.float64),
                              equal_nan=True)
