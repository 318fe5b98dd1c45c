"""The port's MLA block (``repro_torch.models.attention``: ``mla_init``,
``_mla_q``, ``mla_forward``, ``MLACache``, ``mla_init_cache``,
``mla_decode`` naive and absorbed) against the reference's
``repro.models.attention``, and kernel E's function with the q·k head
dim apart from v's.

The configs are the reference test's (``tests/test_attention.py``'s
``_mla_cfg``: d 64, 4 heads, q LoRA 32, kv LoRA 16, q·k 16 + 8, v 16),
the same without a q LoRA (one ``w_q``), and in bf16.  The weights are
the reference's ``mla_init`` leaves with the norm scales drawn at 0.1
(its init leaves them 0), carried to the port as they are; inputs come
from a numpy seed.

Tolerances.  float32: atol 1e-5 / rtol 1e-4 on the forward and on each
of 8 decode steps, naive and absorbed (measured ~1e-6).  bf16: both
frameworks round each product to bf16, XLA's einsums and torch's
matmuls in other orders, so a bf16 ulp flips here and there; each port
formulation is held to the reference's same formulation within
:data:`BF16_WITNESS_RATIO` of the witness, the reference's own float32
run against its bf16 run on the same weights.  The reference's checks
(``TestMLA``) are mirrored on the port: decode matches prefill at 1e-4,
absorbed equals naive at 1e-4, the cache holds kv_lora + rope numbers a
position.  Gradients of ``mla_forward`` (through the flash Function and
the RMSNorm Function on the CPU) against ``jax.grad`` of the same
scalar, within 1e-5 of each leaf's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import flash as JF
from repro.models.common import ModelConfig as JConfig
from repro_torch.kernels import flash_attention as E
from repro_torch.kernels.flash_attention import kernel as EK
from repro_torch.models import attention as TA
from repro_torch.models import flash as TF
from repro_torch.models.common import ModelConfig

F32 = dict(atol=1e-5, rtol=1e-4)
#: The port's bf16 block against the reference's bf16 block at most this
#: many times as far as the reference's float32 block is from it.
BF16_WITNESS_RATIO = 1.5
GRAD_REL = 1e-5
S, STEPS = 32, 8

BASE = dict(name="mla-test", family="moe", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
            attention_kind="mla", q_lora_rank=32, kv_lora_rank=16,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, dtype="float32")
VARIANTS = {"q_lora": {}, "no_q_lora": {"q_lora_rank": 0},
            "bf16": {"dtype": "bfloat16"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's thread a core makes each wait on the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


class Block:
    """One MLA config: the reference's weights (norm scales at 0.1) on
    both sides, inputs x (2, S, d) from a numpy seed, and the reference's
    forward and decode steps, computed once."""

    def __init__(self, variant):
        kw = dict(BASE, **VARIANTS[variant])
        self.cfg, self.jcfg = ModelConfig(**kw), JConfig(**kw)
        self.dtype = jnp.bfloat16 if kw["dtype"] == "bfloat16" \
            else jnp.float32
        p = JA.mla_init(jax.random.key(0), self.jcfg, self.dtype)
        rng = np.random.default_rng(1)
        for name in ("q_norm", "kv_norm"):
            if name in p:
                p[name] = {"scale": jnp.asarray(
                    rng.standard_normal(p[name]["scale"].shape) * 0.1,
                    jnp.float32)}
        self.jparams = p
        self.params = jax.tree.map(_torch, p)
        x = (rng.standard_normal((2, S, self.cfg.d_model)) * 0.5)
        self.x = jnp.asarray(x, jnp.float32).astype(self.dtype)
        self.tx = _torch(self.x)
        self.pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
        self._jax = {}

    def jax_forward(self, cfg=None, params=None, x=None):
        """The reference's forward, jitted (at another config, weights or
        input where given: the witness's float32)."""
        cfg, pos = cfg or self.jcfg, jnp.asarray(self.pos)
        return jax.jit(lambda p, x: JA.mla_forward(
            cfg, p, x, pos, q_block=16, kv_block=16))(
                params or self.jparams, self.x if x is None else x)

    def port_forward(self):
        with torch.no_grad():
            return TA.mla_forward(self.cfg, self.params, self.tx,
                                  torch.as_tensor(self.pos), q_block=16,
                                  kv_block=16)

    def jax_decode(self, absorb):
        """The reference's STEPS steps (jitted): each output and the final
        cache; computed once."""
        if absorb in self._jax:
            return self._jax[absorb]
        cache = JA.mla_init_cache(self.jcfg, 2, STEPS, self.dtype)
        step = jax.jit(lambda p, xt, c, t: JA.mla_decode(
            self.jcfg, p, xt, c, t, absorb=absorb))
        ys = []
        for t in range(STEPS):
            y, cache = step(self.jparams, self.x[:, t:t + 1], cache,
                            jnp.int32(t))
            ys.append(_np(y))
        self._jax[absorb] = ys, cache
        return ys, cache

    def port_decode(self, absorb):
        cache = TA.mla_init_cache(self.cfg, 2, STEPS, self.tx.dtype, "cpu")
        ys = []
        with torch.no_grad():
            for t in range(STEPS):
                y, cache = TA.mla_decode(self.cfg, self.params,
                                         self.tx[:, t:t + 1], cache, t,
                                         absorb=absorb)
                ys.append(y.float().numpy())
        return ys, cache


def _torch(a) -> torch.Tensor:
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module", params=["q_lora", "no_q_lora"])
def block(request):
    """A float32 config, with and without a q LoRA."""
    return Block(request.param)


@pytest.fixture(scope="module")
def bf16_block():
    return Block("bf16")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_has_the_reference_leaves(variant):
    block = Block(variant)
    params = TA.mla_init(block.cfg, block.params["w_o"].dtype,
                         torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), block.jparams)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       params)
    assert got == want
    for name in ("q_norm", "kv_norm"):
        if name in params:
            assert params[name]["scale"].dtype == torch.float32
            assert not bool(params[name]["scale"].any())
    assert ("w_q" in params) == (block.cfg.q_lora_rank == 0)


def test_forward_matches_reference(block):
    got = block.port_forward()
    assert got.shape == tuple(block.x.shape)
    np.testing.assert_allclose(got.numpy(), _np(block.jax_forward()), **F32)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_decode_matches_reference(block, absorb):
    """Each of STEPS steps, and the compressed cache they leave."""
    want, jcache = block.jax_decode(absorb)
    got, cache = block.port_decode(absorb)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **F32, err_msg=f"step {t}")
    np.testing.assert_allclose(cache.c_kv.numpy(), _np(jcache.c_kv), **F32)
    np.testing.assert_allclose(cache.k_pe.numpy(), _np(jcache.k_pe), **F32)


def test_bf16_block_is_within_the_witness(bf16_block):
    """bf16: the forward and both decodes against the reference's same
    formulation, no farther than the reference's float32 run on the same
    weights is from its bf16 run (the witness)."""
    block = bf16_block
    jcfg32 = dataclasses.replace(block.jcfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), block.jparams)
    x32 = block.x.astype(jnp.float32)
    want = _np(block.jax_forward())
    wide = _np(block.jax_forward(jcfg32, p32, x32))
    got = block.port_forward().float().numpy()
    w_diff = np.abs(wide - want).max()
    assert np.abs(got - want).max() <= BF16_WITNESS_RATIO * w_diff
    for absorb in (False, True):
        want_ys, _ = block.jax_decode(absorb)
        wide_ys = _jax_decode32(absorb, jcfg32, p32, x32)
        got_ys, _ = block.port_decode(absorb)
        diff = max(np.abs(g - w).max() for g, w in zip(got_ys, want_ys))
        w_diff = max(np.abs(g - w).max() for g, w in zip(wide_ys, want_ys))
        assert diff <= BF16_WITNESS_RATIO * w_diff, (absorb, diff, w_diff)


def _jax_decode32(absorb, jcfg32, p32, x32) -> list:
    """The reference's STEPS decode steps in float32 (the witness),
    jitted."""
    cache = JA.mla_init_cache(jcfg32, 2, STEPS, jnp.float32)
    step = jax.jit(lambda p, xt, c, t: JA.mla_decode(
        jcfg32, p, xt, c, t, absorb=absorb))
    ys = []
    for t in range(STEPS):
        y, cache = step(p32, x32[:, t:t + 1], cache, jnp.int32(t))
        ys.append(_np(y))
    return ys


def test_decode_matches_prefill(block):
    """The reference's ``TestMLA.test_decode_matches_prefill`` on the
    port: each naive step's output is the forward's at that position."""
    full = block.port_forward().numpy()
    got, _ = block.port_decode(False)
    for t, g in enumerate(got):
        np.testing.assert_allclose(g[:, 0], full[:, t], atol=1e-4,
                                   rtol=1e-4)


def test_absorbed_equals_naive_decode(block):
    """The reference's ``test_absorbed_equals_naive_decode`` on the
    port."""
    naive, c1 = block.port_decode(False)
    absorbed, c2 = block.port_decode(True)
    for a, b in zip(naive, absorbed):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    assert torch.equal(c1.c_kv, c2.c_kv) and torch.equal(c1.k_pe, c2.k_pe)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cache_is_compressed(variant):
    block = Block(variant)
    cfg = block.cfg
    cache = TA.mla_init_cache(cfg, 2, 16, block.tx.dtype, "cpu")
    assert isinstance(cache, TA.MLACache)
    assert tuple(cache.c_kv.shape) == (2, 16, cfg.kv_lora_rank)
    assert tuple(cache.k_pe.shape) == (2, 16, cfg.qk_rope_dim)
    full_kv = 2 * 16 * cfg.num_heads * cfg.v_head_dim * 2
    assert cache.c_kv.numel() + cache.k_pe.numel() < 0.25 * full_kv


def test_decode_writes_only_its_position(block):
    """The token's c_kv and k_pe land at ``pos`` of the cache passed in
    (in place, as gqa_decode's); the other positions keep what they
    held."""
    cache = TA.mla_init_cache(block.cfg, 2, 6, block.tx.dtype, "cpu")
    cache.c_kv.fill_(3.0)
    with torch.no_grad():
        _, out = TA.mla_decode(block.cfg, block.params, block.tx[:, :1],
                               cache, 4)
    assert out.c_kv is cache.c_kv
    assert bool((cache.c_kv[:, [0, 1, 2, 3, 5]] == 3.0).all())
    assert not bool((cache.c_kv[:, 4] == 3.0).any())


def test_q_projection_matches_reference(block):
    qn, qr = TA._mla_q(block.cfg, block.params, block.tx,
                       torch.as_tensor(block.pos))
    jn, jr = jax.jit(lambda p, x: JA._mla_q(block.jcfg, p, x, jnp.asarray(
        block.pos)))(block.jparams, block.x)
    np.testing.assert_allclose(qn.numpy(), _np(jn), **F32)
    np.testing.assert_allclose(qr.numpy(), _np(jr), **F32)


def test_forward_gradients_match_jax(block):
    """d/d(params, x) of sum(mla_forward * g) for a seeded g: the port's
    autograd (through the flash and RMSNorm Functions) against
    ``jax.grad``, each leaf within GRAD_REL of its largest magnitude."""
    g = np.random.default_rng(5).standard_normal(block.x.shape) \
        .astype(np.float32)
    pos = jnp.asarray(block.pos)

    def loss(p, x):
        return jnp.sum(JA.mla_forward(block.jcfg, p, x, pos, q_block=16,
                                      kv_block=16) * g)

    jg_p, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(block.jparams,
                                                         block.x)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(),
                          block.params)
    x = block.tx.clone().requires_grad_()
    y = TA.mla_forward(block.cfg, params, x, torch.as_tensor(block.pos),
                       q_block=16, kv_block=16)
    (y * torch.as_tensor(g)).sum().backward()
    pairs = [(x.grad, jg_x)] + list(zip(
        jax.tree.leaves(jax.tree.map(lambda t: t.grad, params)),
        jax.tree.leaves(jg_p)))
    assert len(pairs) == len(jax.tree.leaves(block.jparams)) + 1
    for got, want in pairs:
        want = _np(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# Kernel E's function with q·k and v head dims apart

#: (b, s, h, kv, dk, dv, q_block, kv_block): the reference test's MLA
#: block (24, 16), the reduced deepseek-v2's (48, 32), GQA with dims apart.
DKV_CASES = [(2, 32, 4, 4, 24, 16, 16, 16), (2, 64, 4, 4, 48, 32, 32, 16),
             (1, 48, 6, 2, 48, 32, 16, 48)]


def _qkv(b, s, h, kv, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dk)).astype(np.float32),
            rng.standard_normal((b, s, kv, dk)).astype(np.float32),
            rng.standard_normal((b, s, kv, dv)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kv,dk,dv,qb,kb", DKV_CASES)
def test_flash_with_dims_apart_matches_reference(b, s, h, kv, dk, dv, qb,
                                                 kb):
    """The port's ``flash_attention`` (blockwise on the CPU), kernel E's
    wrapper and its plain version against the reference's
    ``flash_attention`` and its ``_fwd_pass`` stats, at the MLA scale
    (dk^-0.5); the output takes v's head dim."""
    q, k, v = _qkv(b, s, h, kv, dk, dv, 0)
    scale = dk ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(JF.flash_attention(jq, jk, jv, causal=True,
                                         q_block=qb, kv_block=kb,
                                         scale=scale))
    assert want.shape == (b, s, h, dv)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    for name, got in (
            ("model", TF.flash_attention(tq, tk, tv, q_block=qb,
                                         kv_block=kb, scale=scale)),
            ("wrapper", E.flash_attention_fwd(tq, tk, tv, scale=scale)),
            ("plain", E.flash_attention_ref(tq, tk, tv, scale=scale))):
        assert tuple(got.shape) == (b, s, h, dv), name
        np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=5e-6,
                                   err_msg=name)
    pairs = JA._block_pairs(s // qb, s // kb, qb, kb, 0, True, 0)
    _, jm, jl = JF._fwd_pass(jq, jk, jv, jnp.asarray(pairs), causal=True,
                             window=0, logit_softcap=0.0, q_block=qb,
                             kv_block=kb, scale=scale)
    _, pm, pl = TF._fwd_pass(tq, tk, tv, TA._block_pairs(
        s // qb, s // kb, qb, kb, 0, True, 0), causal=True, window=0,
        logit_softcap=0.0, q_block=qb, kv_block=kb, scale=scale)
    _, em, el = E.flash_attention_fwd(tq, tk, tv, scale=scale,
                                      return_stats=True)
    g = h // kv
    for got_m, got_l in ((pm, pl), (em, el)):
        np.testing.assert_allclose(got_m.numpy(),
                                   np.asarray(jm).reshape(b, s, kv, g),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_l.numpy(),
                                   np.asarray(jl).reshape(b, s, kv, g),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,dk,dv,qb,kb", DKV_CASES[:2])
def test_flash_function_with_dims_apart_matches_reference_vjp(
        b, s, h, kv, dk, dv, qb, kb):
    """(dq, dk, dv) through ``FlashAttentionFunction`` against
    ``jax.vjp`` of the reference's ``flash_attention``."""
    q, k, v = _qkv(b, s, h, kv, dk, dv, 1)
    do = np.random.default_rng(2).standard_normal((b, s, h, dv)) \
        .astype(np.float32)
    scale = dk ** -0.5
    want = jax.jit(lambda a, c, e, g: jax.vjp(
        lambda a, c, e: JF.flash_attention(a, c, e, causal=True,
                                           q_block=qb, kv_block=kb,
                                           scale=scale),
        a, c, e)[1](g))(*(jnp.asarray(a) for a in (q, k, v, do)))
    args = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = TF.flash_attention(*args, q_block=qb, kv_block=kb, scale=scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(out, args, torch.as_tensor(do))
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g_.shape) == w.shape, name
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_wrapper_refuses_k_and_v_that_disagree_but_in_head_dim():
    q = torch.zeros(1, 8, 4, 24)
    with pytest.raises(ValueError, match="Dv"):
        E.flash_attention_fwd(q, torch.zeros(1, 8, 4, 24),
                              torch.zeros(1, 9, 4, 16))
    with pytest.raises(ValueError, match="Dv"):
        E.flash_attention_fwd(q, torch.zeros(1, 8, 4, 16),
                              torch.zeros(1, 8, 4, 16))


#: kernel.plan at MLA's pairs: (dtype, route, keys, stages, shared memory
#: a block).  bf16: q 64 x (dk + 8) and a stage of K (keys x (dk + 8)) and
#: V (keys x (dv + 8)) in bf16, as many stages (2 or 3) as leave two blocks
#: an SM: (192, 128) q 25,600 B + 2 x 43,008 = 111,616.  float32: q 64 x dk,
#: K 32 x (dk + 4), V 32 x dv: 90,624 at (192, 128).
MLA_PLANS = {
    ((192, 128), torch.bfloat16): ("mma", 64, 2, 111_616),
    ((192, 128), torch.float32): ("simt", 32, 1, 90_624),
    ((48, 32), torch.bfloat16): ("mma", 64, 3, 44_032),
    ((48, 32), torch.float32): ("simt", 32, 1, 23_040),
}


@pytest.mark.parametrize("dims,dtype", sorted(MLA_PLANS, key=str))
def test_plan_sizes_shared_memory_from_both_dims(dims, dtype):
    dk, dv = dims
    p = E.plan(1, 4096, 128, 128, dk, dtype, dv)
    assert (p.route, p.keys, p.stages, p.smem_bytes) == \
        MLA_PLANS[dims, dtype]
    if dtype == torch.bfloat16:
        assert p.blocks_per_sm >= 2
        assert p.smem_bytes == 2 * (64 * (dk + 8)
                                    + p.stages * p.keys * (dk + dv + 16))
    assert dims in EK.HEAD_DIMS
    assert p.grid == (4096 * 1 // 64, 128, 1)


@pytest.mark.parametrize("dk,dv", [(192, 64), (96, 64), (128, 192),
                                   (24, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_refuses_a_pair_not_built(dk, dv, dtype):
    with pytest.raises(ValueError, match="head dims"):
        E.plan(1, 64, 4, 4, dk, dtype, dv)
