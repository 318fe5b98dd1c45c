"""Kernel E's function (flash-attention forward) in the port against the
JAX package.

On CPU tensors the port's kernel wrapper
(``repro_torch.kernels.flash_attention``) runs its plain version, the
full softmax of ``flash_attention_ref``, and the LM's
``repro_torch.models.flash.flash_attention`` runs the blockwise online
softmax (``_fwd_pass``).  Both are held against the reference's Pallas
kernel in interpret mode (``repro.kernels.flash_attention``) and its
``repro.models.flash.flash_attention``, on the same numpy inputs: the
cases of the reference's ``tests/test_kernels.py`` (GQA, MHA, MQA, big
head dim, windows, softcap, bf16), queries at the end of a longer key
sequence (Sq < Skv), head dims 32, 64 and 128, and non-causal.
Tolerances are the reference's: 5e-6 for float32 (5e-5 with the softcap,
whose scores are 3x larger), 2e-2 for bf16 outputs.  The CUDA kernel
itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_kernel
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro.models.flash import flash_attention as jax_model_flash
from repro_torch.kernels import flash_attention as E
from repro_torch.models import flash as TF

F32 = dict(atol=5e-6, rtol=5e-6)


def _qkv(b, sq, skv, h, kv, d, seed, mult=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, d)) * mult).astype(np.float32)
    k = (rng.standard_normal((b, skv, kv, d)) * mult).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    return q, k, v


def _port_all(q, k, v, bq, bk, **kw):
    """The port's three routes on CPU tensors: the kernel wrapper, the
    plain full softmax, and the LM's blockwise flash (at the JAX side's
    block sizes; kernel E tiles by its own)."""
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    return {
        "kernel": E.flash_attention_fwd(tq, tk, tv, **kw),
        "ref": E.flash_attention_ref(tq, tk, tv, **kw),
        "model": TF.flash_attention(tq, tk, tv, q_block=bq, kv_block=bk,
                                    **kw),
    }


def _check(q, k, v, bq, bk, tol=F32, **kw):
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = {
        "pallas": np.asarray(jax_kernel(jq, jk, jv, block_q=bq, block_kv=bk,
                                        **kw)),
        "oracle": np.asarray(jax_ref(jq, jk, jv, **kw)),
        "model": np.asarray(jax_model_flash(jq, jk, jv, q_block=bq,
                                            kv_block=bk, **kw)),
    }
    for name, got in _port_all(q, k, v, bq, bk, **kw).items():
        assert got.shape == q.shape and got.dtype == torch.float32
        for wname, w in want.items():
            np.testing.assert_allclose(got.numpy(), w, **tol,
                                       err_msg=f"port {name} vs {wname}")


@pytest.mark.parametrize("b,s,h,kv,d,bq,bk", [
    (2, 256, 4, 2, 128, 64, 128),      # GQA
    (1, 128, 8, 8, 128, 32, 32),       # MHA
    (2, 256, 4, 1, 128, 128, 64),      # MQA, uneven blocks
    (1, 512, 2, 2, 256, 128, 128),     # big head dim (gemma-2-ish)
])
def test_reference_cases(b, s, h, kv, d, bq, bk):
    _check(*_qkv(b, s, s, h, kv, d, 0), bq, bk)


@pytest.mark.parametrize("window", [32, 100])
def test_sliding_window(window):
    _check(*_qkv(1, 256, 256, 4, 2, 128, 1), 64, 64, window=window)


def test_logit_softcap():
    q, k, v = _qkv(1, 128, 128, 4, 4, 128, 2, mult=3.0)
    _check(q, k, v, 32, 32, tol=dict(atol=5e-5, rtol=5e-5),
           logit_softcap=50.0)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_head_dims_with_window_and_softcap(d):
    _check(*_qkv(2, 128, 128, 6, 2, d, 3), 32, 64, window=48,
           logit_softcap=50.0)


@pytest.mark.parametrize("sq,skv,window", [(64, 256, 0), (128, 512, 100),
                                           (32, 96, 40)])
def test_queries_at_the_end_of_longer_keys(sq, skv, window):
    """seq_offset = Skv - Sq > 0: query i sits at absolute i + offset."""
    _check(*_qkv(1, sq, skv, 4, 2, 64, 4), 32, 32, window=window)


def test_non_causal():
    _check(*_qkv(2, 128, 128, 4, 2, 64, 5), 64, 64, causal=False)


def test_bfloat16_io():
    q, k, v = _qkv(1, 128, 128, 2, 2, 128, 6)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_kernel(*jb, block_q=64, block_kv=64)
                      .astype(jnp.float32))
    tb = [torch.as_tensor(a).bfloat16() for a in (q, k, v)]
    for got in (E.flash_attention_fwd(*tb),
                TF.flash_attention(*tb, q_block=64, kv_block=64)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    tq, tk, tv = (torch.as_tensor(a) for a in _qkv(1, 64, 64, 4, 2, 32, 7))
    before = E.flash_attention_fwd.launches
    assert torch.equal(E.flash_attention_fwd(tq, tk, tv, window=16),
                       E.flash_attention_ref(tq, tk, tv, window=16))
    assert E.flash_attention_fwd.launches == before


def test_gradient_and_p_bf16_are_refused():
    """Neither is refused any longer: ``p_bf16`` runs the reference's
    bf16-probability route (held against the reference in
    ``test_torch_flash_p_bf16.py``), and a call that needs a gradient
    goes through the recompute backward (``FlashAttentionFunction``),
    with ``p_bf16`` too."""
    tq, tk, tv = (torch.as_tensor(a) for a in _qkv(1, 64, 64, 4, 2, 32, 8))
    p16 = TF.flash_attention(tq.detach(), tk, tv, p_bf16=True)
    assert p16.grad_fn is None and bool(torch.isfinite(p16).all())
    assert not torch.equal(p16, TF.flash_attention(tq.detach(), tk, tv))
    out = TF.flash_attention(tq.clone().requires_grad_(), tk, tv,
                             p_bf16=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert torch.equal(out.detach(), p16)
    tq.requires_grad_()
    out = TF.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    with torch.no_grad():
        assert torch.equal(TF.flash_attention(tq, tk, tv), out.detach())


def _t(shape, dtype=torch.float32, **kw):
    return torch.zeros(shape, dtype=dtype, **kw)


@pytest.mark.parametrize("q, k, v, exc", [
    (_t((1, 8, 4, 32), torch.float16), _t((1, 8, 2, 32), torch.float16),
     _t((1, 8, 2, 32), torch.float16), TypeError),
    (_t((1, 8, 4, 32)), _t((1, 8, 2, 32), torch.bfloat16),
     _t((1, 8, 2, 32)), TypeError),
    (_t((1, 8, 4, 32)), _t((1, 8, 3, 32)), _t((1, 8, 3, 32)), ValueError),
    (_t((1, 8, 4, 32)), _t((1, 8, 2, 16)), _t((1, 8, 2, 16)), ValueError),
    (_t((1, 8, 4, 32)), _t((1, 8, 2, 32)), _t((1, 9, 2, 32)), ValueError),
    (_t((1, 4, 8, 32)).transpose(1, 2), _t((1, 8, 2, 32)),
     _t((1, 8, 2, 32)), ValueError),
    (_t((8, 4, 32)), _t((8, 2, 32)), _t((8, 2, 32)), ValueError),
    # meta tensors are shapes to count (an empty result, no launch), but
    # not beside a tensor on a device
    (_t((1, 8, 4, 32), device="meta"), _t((1, 8, 2, 32), device="meta"),
     _t((1, 8, 2, 32)), ValueError),
], ids=["float16", "mixed-dtypes", "heads", "head-dim", "kv-lengths",
        "strided", "3-D", "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(q, k, v, exc):
    with pytest.raises(exc):
        E.flash_attention_fwd(q, k, v)
