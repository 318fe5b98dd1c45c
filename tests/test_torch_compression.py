"""The port's gradient compression (``repro_torch.optim.compression``)
against the reference's ``repro.optim.compression``: the reference's
three ``TestCompression`` tests case for case, then int8 and bf16
payloads, int8 scales and the error feedback bitwise on a nested tree of
float32 leaves over several steps (``jnp.round`` and ``torch.round``
both round half to even; ``x / scale`` and ``amax / 127`` are true
divisions in both, the reference run eagerly), and the tree handling of
the :class:`Compressed` named tuple.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as JC
from repro_torch import optim
from repro_torch.optim import compression as TC

STEPS = 3


def _tree(seed=0):
    """A nested float32 tree: a dict of dicts, a list, a tuple, scales
    from tiny to large, a leaf of zeros and one with exact ties."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ties = np.arange(-127, 128, dtype=np.float32) / 2.0       # x.5 steps
    return {"layers": [{"w": n(64, 33) * 1e-3, "b": n(7)},
                       {"w": n(5, 5) * 100.0, "b": np.zeros(5, np.float32)}],
            "head": (n(3, 4), ties),
            "norm": {"scale": n(16) * 1e-8}}


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    t = np.asarray(t)
    if t.dtype.name == "bfloat16":
        t = t.view(np.int16)
    return np.ascontiguousarray(t).tobytes()


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, JC.Compressed))


def test_roundtrip_int8_close():
    g = {"w": torch.as_tensor(np.array(
        jax.random.normal(jax.random.key(0), (64, 64))))}
    ef = TC.init_error_feedback(g)
    comp, ef = TC.compress_with_feedback(g, ef, TC.CompressionConfig("int8"))
    back = TC.decompress_tree(comp)
    rel = float(torch.linalg.norm(back["w"] - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02


def test_error_feedback_reinjects_residual():
    """With EF, the *sum* of transmitted gradients converges to the sum
    of true gradients (unbiasedness over time)."""
    cfg = TC.CompressionConfig(kind="int8", error_feedback=True)
    g = {"w": torch.full((32,), 0.001)}
    ef = TC.init_error_feedback(g)
    total = torch.zeros(32)
    n = 50
    for _ in range(n):
        comp, ef = TC.compress_with_feedback(g, ef, cfg)
        total = total + TC.decompress_tree(comp)["w"]
    true_total = g["w"] * n
    rel = float(torch.linalg.norm(total - true_total)
                / torch.linalg.norm(true_total))
    assert rel < 0.05


def test_bytes_accounting():
    g = {"w": torch.zeros(1000)}
    assert TC.compressed_bytes(g, TC.CompressionConfig("int8")) == 1000
    assert TC.compressed_bytes(g, TC.CompressionConfig("bf16")) == 2000
    assert TC.compressed_bytes(g, TC.CompressionConfig("none")) == 4000


@pytest.mark.parametrize("kind", ["int8", "bf16", "none"])
@pytest.mark.parametrize("feedback", [True, False], ids=["ef", "no_ef"])
def test_bitwise_against_reference(kind, feedback):
    """STEPS steps of ``compress_with_feedback`` on the same tree, each
    step's payloads, scales, new error feedback and decompressed tree
    bitwise the reference's; the trees keep their structure (a list, a
    tuple, nested dicts)."""
    tree = _tree()
    jt = jax.tree.map(jnp.asarray, tree)
    tt = jax.tree.map(torch.as_tensor, tree)
    jcfg = JC.CompressionConfig(kind, feedback)
    tcfg = TC.CompressionConfig(kind, feedback)
    je, te = JC.init_error_feedback(jt), TC.init_error_feedback(tt)
    for step in range(STEPS):
        jc, je = JC.compress_with_feedback(jt, je, jcfg)
        tc, te = TC.compress_with_feedback(tt, te, tcfg)
        assert isinstance(tc["head"], tuple) and isinstance(tc["layers"],
                                                            list)
        got, want = TC._leaves(tc), _jleaves(jc)
        assert len(got) == len(want) == 7
        for i, (a, b) in enumerate(zip(got, want)):
            assert isinstance(a, TC.Compressed)
            assert _bits(a.payload) == _bits(b.payload), (step, i)
            assert (a.scale is None) == (b.scale is None)
            if a.scale is not None:
                assert a.scale.dtype == torch.float32 and a.scale.ndim == 0
                assert _bits(a.scale) == _bits(b.scale), (step, i)
        for a, b in zip(TC._leaves(te), jax.tree.leaves(je)):
            assert _bits(a) == _bits(b), step
        for a, b in zip(TC._leaves(TC.decompress_tree(tc)),
                        jax.tree.leaves(JC.decompress_tree(jc))):
            assert _bits(a) == _bits(b), step
        # the next step's gradients: the same tree, scaled
        tt = jax.tree.map(lambda t: t * 0.5, tt)
        jt = jax.tree.map(lambda t: t * 0.5, jt)
    assert TC.compressed_bytes(tt, tcfg) == JC.compressed_bytes(jt, jcfg)


def test_int8_ties_round_half_to_even():
    """A leaf whose largest magnitude is 127 has scale 1: its x.5 values
    round to the even neighbour, as ``jnp.round`` does."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    c = TC.compress_leaf(x, "int8")
    assert float(c.scale) == 1.0
    assert c.payload.tolist() == [127, 0, 2, 2, 0, -2, -2]
    assert c.payload.dtype == torch.int8


def test_compressed_is_a_leaf_of_the_tree_helpers():
    """``Compressed`` is a named tuple: the helpers treat it as a leaf
    (rebuilding one from a generator would fail), and ``scale`` is None
    for bf16 and none."""
    tree = {"a": [torch.ones(3)], "b": (torch.zeros(2),)}
    for kind in ("bf16", "none"):
        comp, ef = TC.compress_with_feedback(
            tree, TC.init_error_feedback(tree), TC.CompressionConfig(kind))
        leaves = TC._leaves(comp)
        assert all(isinstance(c, TC.Compressed) and c.scale is None
                   for c in leaves)
        back = TC.decompress_tree(comp, torch.bfloat16)
        assert back["a"][0].dtype == torch.bfloat16
        assert isinstance(back["b"], tuple)
    assert TC.compressed_bytes(tree, TC.CompressionConfig("int8")) == 5


def test_exported_from_the_optim_package():
    for name in ("CompressionConfig", "Compressed", "compress_leaf",
                 "decompress_leaf", "init_error_feedback",
                 "compress_with_feedback", "decompress_tree",
                 "compressed_bytes"):
        assert getattr(optim, name) is getattr(TC, name)
    with pytest.raises(ValueError):
        TC.compress_leaf(torch.ones(2), "fp8")
