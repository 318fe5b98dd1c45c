"""The port's shared tree helper (``repro_torch.tree``) and the public
entry points that walk trees with it, against the reference's
``jax.tree`` handling: a named tuple node is rebuilt by its fields and
a ``None`` is an empty subtree, in ``compress_with_feedback``,
``init_error_feedback``, ``decompress_tree``, ``compressed_bytes``,
``adamw.init`` and ``adamw.apply`` (the reference's ``repro.optim``
modules import without the child shim, so they run in process)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.tree import is_namedtuple, tree_leaves, tree_map


class P(NamedTuple):
    a: object
    b: object


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel
    worker processes on a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": P(n(6, 5), n(7)), "y": None,
            "z": [n(3), (n(2, 2), None)], "w": P(None, n(4))}


def _to(tree, conv):
    """``tree`` (of numpy leaves) with ``conv`` on every leaf, built
    without either package's helper."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_to(v, conv) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, conv) for v in tree)
    return conv(tree)


def _bits(x) -> tuple:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return (x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes())


def _canon(tree):
    """A comparable form: node types by name, leaves by their bits."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", {k: _canon(v) for k, v in tree.items()})
    if is_namedtuple(tree):
        return (type(tree).__name__, tuple(_canon(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_canon(v) for v in tree))
    return _bits(tree)


def _port(tree):
    return _to(tree, torch.as_tensor)


def _ref(tree):
    return _to(tree, jnp.asarray)


def test_tree_map_rebuilds_named_tuples_and_passes_none():
    seen = []
    t = {"x": P(1, None), "y": None, "z": [2, (3,)]}
    got = tree_map(lambda v: seen.append(v) or v * 10, t)
    assert got == {"x": P(10, None), "y": None, "z": [20, (30,)]}
    assert type(got["x"]) is P and seen == [1, 2, 3]
    assert tree_map(lambda a, b: a + b, t, got) == {
        "x": P(11, None), "y": None, "z": [22, (33,)]}
    assert tree_leaves(t) == [1, 2, 3]
    assert tree_leaves({"b": 1, "a": 2}) == [2, 1]      # sorted keys
    assert tree_leaves(P(1, 2), is_leaf=is_namedtuple) == [P(1, 2)]
    assert tree_map(lambda p: p.a, [P(1, 2)], is_leaf=is_namedtuple) == [1]


def test_tree_leaves_follow_the_reference_order():
    t = _numpy_tree()
    want = jax.tree.leaves(_ref(t))
    got = tree_leaves(_port(t))
    assert [_bits(a) for a in got] == [_bits(b) for b in want]


@pytest.mark.parametrize("kind", ["int8", "bf16", "none"])
def test_compression_entry_points_on_named_tuples_and_none(kind):
    t = _numpy_tree()
    cfg_t, cfg_j = TC.CompressionConfig(kind), JC.CompressionConfig(kind)
    ef_t, ef_j = TC.init_error_feedback(_port(t)), \
        JC.init_error_feedback(_ref(t))
    assert _canon(ef_t) == _canon(ef_j)
    for step in range(2):
        g = _numpy_tree(seed=step + 1)
        comp_t, ef_t = TC.compress_with_feedback(_port(g), ef_t, cfg_t)
        comp_j, ef_j = JC.compress_with_feedback(_ref(g), ef_j, cfg_j)
        assert _canon(comp_t) == _canon(comp_j), step
        assert _canon(ef_t) == _canon(ef_j), step
        assert type(comp_t["x"]) is P and comp_t["y"] is None
        assert _canon(TC.decompress_tree(comp_t)) == _canon(
            JC.decompress_tree(comp_j))
    assert TC.compressed_bytes(_port(t), cfg_t) == \
        JC.compressed_bytes(_ref(t), cfg_j)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_init_and_apply_on_named_tuples_and_none(moments):
    t = _numpy_tree()
    cfg_t = TA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           moment_dtype=moments)
    cfg_j = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           moment_dtype=moments)
    p_t, p_j = _port(t), _ref(t)
    s_t, s_j = TA.init(cfg_t, p_t), JA.init(cfg_j, p_j)
    assert _canon(s_t.mu) == _canon(s_j.mu)
    assert _canon(s_t.nu) == _canon(s_j.nu)
    for step in range(3):
        g = _numpy_tree(seed=10 + step)
        p_t, s_t, m_t = TA.apply(cfg_t, p_t, _port(g), s_t)
        p_j, s_j, m_j = JA.apply(cfg_j, p_j, _ref(g), s_j)
        # the structure exactly; float32 values within a few ulps (the
        # reference's cosine schedule differs from torch's by ulps,
        # tests/test_torch_adamw.py)
        assert jax.tree.structure(_ref(_to_numpy(p_t))) == \
            jax.tree.structure(p_j)
        for a, b in zip(tree_leaves(p_t), jax.tree.leaves(p_j)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-5, atol=1e-7)
        for got, want in ((s_t.mu, s_j.mu), (s_t.nu, s_j.nu)):
            assert jax.tree.structure(_ref(_to_numpy(got))) == \
                jax.tree.structure(want)
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert a.dtype == getattr(torch, moments)
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=2e-2 if moments ==
                                           "bfloat16" else 1e-5,
                                           atol=1e-7)
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-6)
    assert type(p_t["x"]) is P and p_t["y"] is None and \
        p_t["w"].a is None


def _to_numpy(tree):
    return tree_map(lambda x: x.detach().float().numpy(), tree)
