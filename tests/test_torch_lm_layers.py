"""The port's LM layers (``repro_torch.models.layers``) against the
reference's ``repro.models.layers`` on the same numpy inputs: RoPE and
M-RoPE, softcap, the FFNs, and the embed/unembed pair.  float32 within 1e-6
(float32 math in another order; ``sin``/``cos``/``tanh`` of two
libraries), bf16 within one bf16 ulp of |x| <= 8 (2^-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

F32 = dict(atol=1e-6, rtol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("head_dim,theta", [(32, 1e4), (64, 1e6),
                                            (256, 1e4)])
def test_rope_matches_reference(head_dim, theta):
    rng = _rng(0)
    x = rng.standard_normal((2, 40, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 40)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    # Angles up to 8192 rad: float32 sin/cos of two libraries differ by
    # an ulp of the angle's reduction, ~1e-6 relative at that size.
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        TL.rope_frequencies(head_dim, theta).numpy(),
        np.asarray(JL.rope_frequencies(head_dim, theta)), **F32)


def test_rope_halves_not_interleaved_and_bf16_cast_back():
    """Position 0 is the identity; at position 1 the pair (i, i + D/2)
    rotates together, as ``jnp.split`` pairs them."""
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 1, 8)
    assert torch.equal(TL.apply_rope(x, torch.zeros(1, 1), 1e4), x)
    y = TL.apply_rope(x, torch.ones(1, 1), 1e4)
    ang = TL.rope_frequencies(8, 1e4)
    want0 = x[..., 0] * torch.cos(ang[0]) - x[..., 4] * torch.sin(ang[0])
    assert torch.allclose(y[..., 0], want0)
    xb = x.bfloat16()
    assert TL.apply_rope(xb, torch.ones(1, 1), 1e4).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_matches_reference(dtype):
    x = (_rng(1).standard_normal((4, 300)) * 40).astype(np.float32)
    want = np.asarray(JL.softcap(jnp.asarray(x, dtype), 30.0)
                      .astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = TL.softcap(tx, 30.0)
    assert got.dtype == tx.dtype
    tol = dict(atol=1e-5, rtol=1e-6) if dtype == "float32" else \
        dict(atol=2 ** -3, rtol=0)      # one bf16 ulp at |y| < 30
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert TL.softcap(tx, 0.0) is tx
    assert torch.equal(tx, torch.as_tensor(x).to(tx.dtype))   # not in place


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_dense_ffn_matches_reference(kind):
    rng = _rng(2)
    p = {"w_up": rng.standard_normal((64, 96)) / 8,
         "w_down": rng.standard_normal((96, 64)) / 10}
    if kind == "swiglu":
        p["w_gate"] = rng.standard_normal((64, 96)) / 8
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(JL.dense_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), kind))
    got = TL.dense_ffn({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x), kind)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("d,dtype", [(128, "float32"), (128, "bfloat16"),
                                     (2304, "bfloat16")])
def test_embed_unembed_tied_match_reference(d, dtype):
    rng = _rng(3)
    table = (rng.standard_normal((50, d)) * d ** -0.5).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    jt = jnp.asarray(table, dtype)
    tt = torch.as_tensor(table).to(getattr(torch, dtype))
    want_x = JL.embed({"table": jt}, jnp.asarray(toks), True, d)
    got_x = TL.embed({"table": tt}, torch.as_tensor(toks), True, d)
    np.testing.assert_array_equal(got_x.float().numpy(),
                                  np.asarray(want_x.astype(jnp.float32)))
    want = np.asarray(JL.unembed(None, want_x, 30.0, jt).astype(jnp.float32))
    got = TL.unembed(None, got_x, 30.0, tt)
    assert got.dtype == tt.dtype
    tol = F32 if dtype == "float32" else dict(atol=2 ** -4, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_embed_scale_is_rounded_to_the_table_dtype():
    """jnp.asarray(d ** 0.5, bf16): 11.3125 at d = 128 (not 11.3137),
    48 exactly at gemma2-2b's d = 2304."""
    one = torch.ones((1, 128), dtype=torch.bfloat16)
    x = TL.embed({"table": one}, torch.zeros((1, 1), dtype=torch.int64),
                 True, 128)
    assert x.float()[0, 0, 0].item() == 11.3125
    one = torch.ones((1, 2304), dtype=torch.bfloat16)
    x = TL.embed({"table": one}, torch.zeros((1, 1), dtype=torch.int64),
                 True, 2304)
    assert x.float()[0, 0, 0].item() == 48.0


def test_untied_unembed_matches_reference():
    rng = _rng(4)
    w = (rng.standard_normal((32, 40)) / 6).astype(np.float32)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    want = np.asarray(JL.unembed({"w": jnp.asarray(w)}, jnp.asarray(x)))
    got = TL.unembed({"w": torch.as_tensor(w)}, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_mrope_is_a_later_slice():
    """M-RoPE came with the modality-stub slice: the call that raised
    before it now agrees with the reference (``tests/test_torch_mrope.py``
    holds it at qwen2-vl's sections)."""
    rng = _rng(5)
    x = rng.standard_normal((1, 2, 2, 8)).astype(np.float32)
    pos3 = rng.integers(0, 64, (3, 1, 2)).astype(np.int32)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4,
                                     (2, 1, 1)))
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e4,
                         (2, 1, 1))
    np.testing.assert_allclose(got.numpy(), want, **F32)
