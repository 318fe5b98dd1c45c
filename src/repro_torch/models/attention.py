"""Attention of the port's LM: the reference's
``repro/models/attention.py``, GQA (RoPE or M-RoPE, sliding windows,
logit softcap) and MLA (DeepSeek-V2's multi-head latent attention).

Two paths, as in the reference:

* **prompt forward and training** — :func:`gqa_forward` projects q, k
  and v and calls :func:`repro_torch.models.flash.flash_attention`,
  which is kernel E on the card (with a recompute backward in torch
  ops); :func:`blockwise_attention` is the reference's plain online-
  softmax twin, differentiable by autograd;
* **decode** — :func:`gqa_decode` writes one token's k and v into a
  preallocated cache and attends over it with :func:`decode_attention`,
  plain tensor code that masks by ``cache_len`` over the whole cache and
  takes a full softmax, as the reference computes it outside any Pallas
  kernel.

MLA (:func:`mla_forward`, :func:`mla_decode`) projects q through a
low-rank ``w_dq`` / ``q_norm`` / ``w_uq`` (or one ``w_q``), and k and v
from a compressed latent ``c_kv`` (``w_dkv`` then ``kv_norm``) beside
one rope key ``k_pe`` shared by every head.  Its prompt attention is the
same :func:`repro_torch.models.flash.flash_attention` (kernel E on the
card) with q·k over ``qk_nope + qk_rope`` and v over ``v_head_dim``;
its norms are :func:`.layers.rmsnorm` (kernel D on the card).  The
decode cache (:class:`MLACache`) holds ``c_kv`` and ``k_pe`` only; a
step either expands them into k and v for the whole cache (naive) or
folds ``w_uk`` into q and attends in the latent space (absorbed), with
the reference's casts at each point.

Weights keep the reference's einsum layouts (``w_q`` (d, H, Dh),
``w_o`` (H, Dh, d)); attention tensors are (B, S, H, Dh).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref

from .common import ModelConfig
from .layers import apply_mrope, apply_rope, normal, rmsnorm
from .sharding import BATCH, constrain, merge_dims, unflatten_last


def _block_pairs(n_q: int, n_kv: int, q_block: int, kv_block: int,
                 seq_offset: int, causal: bool,
                 window: int) -> list[tuple[int, int]]:
    """Statically enumerate (q_block, kv_block) pairs intersecting the mask.

    Works in absolute positions, so unequal block sizes and
    prefix-offset queries (``seq_offset = skv - sq``) are handled.  Pairs
    are ordered by q block then kv block, which the online-softmax update
    requires.  ``window`` prunes kv blocks entirely below the sliding
    window.
    """
    pairs = []
    for qi in range(n_q):
        q_lo = qi * q_block + seq_offset        # first absolute q position
        q_hi = q_lo + q_block - 1               # last absolute q position
        for kj in range(n_kv):
            k_lo = kj * kv_block
            k_hi = k_lo + kv_block - 1
            if causal and k_lo > q_hi:
                continue                        # fully above the diagonal
            if window and k_hi <= q_lo - window:
                continue                        # fully below the window
            pairs.append((qi, kj))
    return pairs


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0, q_block: int = 512,
                        kv_block: int = 512,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh) with H = G*KV.

    Returns (B, Sq, H, Dv).  The flash-attention algorithm (online
    softmax) over the statically enumerated block pairs, as plain tensor
    code written out of place, so that autograd differentiates it as
    ``jax.grad`` goes through the reference's scan: each q block's
    (o, m, l) is a new tensor at every pair it meets.
    """
    b, sq, h, dh = q.shape
    _, skv, kv_heads, dv = v.shape
    g = h // kv_heads
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    if sq % q_block or skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) do not tile "
                         f"(Sq, Skv) = ({sq}, {skv})")
    n_q, n_kv = sq // q_block, skv // kv_block
    scale = scale if scale is not None else dh ** -0.5
    seq_offset = skv - sq
    pairs = _block_pairs(n_q, n_kv, q_block, kv_block, seq_offset,
                         causal, window)

    qb = q.reshape(b, n_q, q_block, kv_heads, g, dh)
    kb = k.reshape(b, n_kv, kv_block, kv_heads, dh)
    vb = v.reshape(b, n_kv, kv_block, kv_heads, dv)
    dev = q.device
    o = [torch.zeros((b, q_block, kv_heads, g, dv), dtype=torch.float32,
                     device=dev) for _ in range(n_q)]
    m = [torch.full((b, q_block, kv_heads, g), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(n_q)]
    l = [torch.zeros((b, q_block, kv_heads, g), dtype=torch.float32,
                     device=dev) for _ in range(n_q)]
    q_pos = torch.arange(q_block, device=dev)
    k_pos = torch.arange(kv_block, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    for qi, kj in pairs:
        s = torch.einsum("bqkgd,btkd->bqkgt", qb[:, qi].float(),
                         kb[:, kj].float()) * scale
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        qpos = qi * q_block + q_pos + seq_offset
        kpos = kj * kv_block + k_pos
        mask = torch.ones((q_block, kv_block), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_old, l_old = m[qi], l[qi]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        # guard fully-masked rows (m_new == NEG_INF)
        m_safe = torch.where(m_new <= NEG_INF / 2, zero, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), zero)
        alpha = torch.where(m_old <= NEG_INF / 2, zero,
                            torch.exp(m_old - m_safe))
        l[qi] = l_old * alpha + p.sum(dim=-1)
        o[qi] = o[qi] * alpha[..., None] + torch.einsum(
            "bqkgt,btkd->bqkgd", p, vb[:, kj].float())
        m[qi] = m_new

    out = torch.stack(o, dim=1) / torch.clamp_min(
        torch.stack(l, dim=1)[..., None], 1e-30)
    return out.reshape(b, sq, h, dv).to(q.dtype)


#: The O(S^2)-memory oracle of the reference's tests (small shapes
#: only): the same full softmax as kernel E's plain version.
full_attention_reference = flash_attention_ref


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window=0,
                     logit_softcap=0.0, scale=None):
    """Single-token attention over a preallocated cache.

    q: (B, 1, H, Dh); caches: (B, S_max, KV, Dh); ``cache_len`` — number
    of valid positions INCLUDING the token just inserted.
    """
    b, _, h, dh = q.shape
    _, s_max, kv_heads, dv = v_cache.shape
    g = h // kv_heads
    scale = scale if scale is not None else dh ** -0.5
    # under a mesh the cache is sequence-sharded: each shard attends
    # with every head of the token's q (a no-op without a mesh)
    q = constrain(q, BATCH, None, None, None)
    qg = q.reshape(b, kv_heads, g, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    kpos = torch.arange(s_max, device=q.device)
    valid = kpos < cache_len
    if window:
        valid &= kpos > cache_len - 1 - window
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def gqa_init(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    s = d ** -0.5
    p = {
        "w_q": normal((d, h, hd), s, dtype, generator, device),
        "w_k": normal((d, kvh, hd), s, dtype, generator, device),
        "w_v": normal((d, kvh, hd), s, dtype, generator, device),
        "w_o": normal((h, hd, d), (h * hd) ** -0.5, dtype, generator,
                      device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["b_k"] = torch.zeros((kvh, hd), dtype=dtype, device=device)
        p["b_v"] = torch.zeros((kvh, hd), dtype=dtype, device=device)
    return p


def _rope_or_mrope(cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    if not cfg.use_rope:
        return x
    if cfg.mrope_sections:
        if positions.ndim == 2:     # text only: t = h = w
            positions = positions[None].expand(3, *positions.shape)
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    return unflatten_last(x @ merge_dims(w, 1, w.ndim), w.shape[1:])


def _qkv(cfg: ModelConfig, params: dict, x: torch.Tensor,
         positions: torch.Tensor):
    q = _project(x, params["w_q"])
    k = _project(x, params["w_k"])
    v = _project(x, params["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return (_rope_or_mrope(cfg, q, positions),
            _rope_or_mrope(cfg, k, positions), v)


def _out(o: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, w_o)`` as one matmul."""
    return merge_dims(o, 2, 4) @ merge_dims(w_o, 0, 2)


def gqa_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0,
                q_block: int = 512, kv_block: int = 512) -> torch.Tensor:
    """Full-sequence (prompt) GQA: kernel E on the card."""
    from .flash import flash_attention  # local import, as the reference's
    q, k, v = _qkv(cfg, params, x, positions)
    o = flash_attention(q, k, v.contiguous(), causal=True, window=window,
                        logit_softcap=cfg.attn_logit_softcap,
                        q_block=q_block, kv_block=kv_block,
                        p_bf16=cfg.attn_p_bf16)
    return _out(o, params["w_o"])


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, Dh)
    v: torch.Tensor       # (B, S_max, KV, Dh)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> KVCache:
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((batch, max_len, kvh, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, kvh, hd), dtype=dtype, device=device))


def gqa_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: KVCache, pos: int, *,
               window: int = 0) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d); ``pos`` the cache index to write.

    The reference returns a new cache (``dynamic_update_slice``); the
    port writes the token into ``cache`` in place and returns it.  k and
    v are cast into the cache's dtype (the compute dtype) before the
    write, as in the reference.
    """
    pos_b = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                       device=x.device)
    q, k, v = _qkv(cfg, params, x, pos_b)
    cache.k[:, pos:pos + 1] = k.to(cache.k.dtype)
    cache.v[:, pos:pos + 1] = v.to(cache.v.dtype)
    o = decode_attention(q, cache.k, cache.v, pos + 1, window=window,
                         logit_softcap=cfg.attn_logit_softcap)
    return _out(o, params["w_o"]), cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(cfg: ModelConfig, dtype, generator, device) -> dict:
    """MLA weights with the reference's fan-in scales: with a q LoRA
    ``w_dq`` (d, q_lora), ``q_norm`` and ``w_uq`` (q_lora, H, nope +
    rope), else ``w_q`` (d, H, nope + rope); ``w_dkv`` (d, kv_lora),
    ``kv_norm``, ``w_kr`` (d, rope), ``w_uk`` (kv_lora, H, nope), ``w_uv``
    (kv_lora, H, v) and ``w_o`` (H, v, d).  The norm scales are float32
    zeros, as every norm's."""
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    r = cfg.kv_lora_rank
    s = d ** -0.5
    p: dict = {}
    if cfg.q_lora_rank:
        ql = cfg.q_lora_rank
        p["w_dq"] = normal((d, ql), s, dtype, generator, device)
        p["q_norm"] = {"scale": torch.zeros((ql,), dtype=torch.float32,
                                            device=device)}
        p["w_uq"] = normal((ql, h, qk), ql ** -0.5, dtype, generator, device)
    else:
        p["w_q"] = normal((d, h, qk), s, dtype, generator, device)
    p["w_dkv"] = normal((d, r), s, dtype, generator, device)
    p["kv_norm"] = {"scale": torch.zeros((r,), dtype=torch.float32,
                                         device=device)}
    p["w_kr"] = normal((d, cfg.qk_rope_dim), s, dtype, generator, device)
    p["w_uk"] = normal((r, h, cfg.qk_nope_dim), r ** -0.5, dtype, generator,
                       device)
    p["w_uv"] = normal((r, h, cfg.v_head_dim), r ** -0.5, dtype, generator,
                       device)
    p["w_o"] = normal((h, cfg.v_head_dim, d), (h * cfg.v_head_dim) ** -0.5,
                      dtype, generator, device)
    return p


def _mla_q(cfg: ModelConfig, params: dict, x: torch.Tensor,
           positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (q_nope (B,S,H,nope), q_rope (B,S,H,rope)): through the q
    LoRA (``x @ w_dq``, ``q_norm``, ``w_uq``) where the config has one,
    each product in the compute dtype."""
    if cfg.q_lora_rank:
        cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = _project(cq, params["w_uq"])
    else:
        q = _project(x, params["w_q"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv(cfg: ModelConfig, params: dict, x: torch.Tensor,
            positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed latent ``c_kv`` (B, S, kv_lora) after ``kv_norm``
    and the rope key ``k_pe`` (B, S, 1, rope) of each position."""
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    k_pe = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                      cfg.rope_theta)
    return c_kv, k_pe


def mla_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor, *, q_block: int = 512,
                kv_block: int = 512) -> torch.Tensor:
    """Full-sequence MLA (prompt / training): expand the latents into k
    (``k_nope`` beside the shared ``k_pe``, broadcast to every head) and
    v, then attend: kernel E on the card, q·k over nope + rope, v over
    ``v_head_dim``, scale (nope + rope)^-0.5.  The attention-kind keys of
    GQA (kv heads, softcap, window, biases) do not apply."""
    from .flash import flash_attention  # local import, as the reference's
    q_nope, q_rope = _mla_q(cfg, params, x, positions)
    c_kv, k_pe = _mla_kv(cfg, params, x, positions)
    k_nope = _project(c_kv, params["w_uk"])
    v = _project(c_kv, params["w_uv"])
    b, s, h = q_nope.shape[:3]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    o = flash_attention(q, k, v, causal=True, q_block=q_block,
                        kv_block=kv_block,
                        scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5,
                        p_bf16=cfg.attn_p_bf16)
    return _out(o, params["w_o"])


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S_max, kv_lora)
    k_pe: torch.Tensor    # (B, S_max, rope_dim)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_pe=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                         device=device))


def mla_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: MLACache, pos: int, *,
               absorb: bool = False) -> tuple[torch.Tensor, MLACache]:
    """One-token MLA decode.  x: (B, 1, d); ``pos`` the cache index to
    write.  The token's ``c_kv`` and ``k_pe`` are cast into the cache's
    dtype and written into ``cache`` in place (the reference returns a
    new cache), which is returned.

    ``absorb=False`` — naive: expand k_nope and v (compute dtype) for the
    whole cache every step, scores and p@v in float32.
    ``absorb=True``  — absorbed: fold ``w_uk`` into q (compute dtype) and
    attend in the latent space in float32; the latent context is cast to
    the compute dtype before ``w_uv``, as the reference does.
    Both mask with ``kpos <= pos`` over the whole cache and take a full
    softmax."""
    b = x.shape[0]
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, params, x, pos_b)
    c_new, kpe_new = _mla_kv(cfg, params, x, pos_b)
    cache.c_kv[:, pos:pos + 1] = c_new.to(cache.c_kv.dtype)
    cache.k_pe[:, pos:pos + 1] = kpe_new[:, :, 0, :].to(cache.k_pe.dtype)
    c_kv, k_pe = cache
    s_max = c_kv.shape[1]
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    valid = torch.arange(s_max, device=x.device) <= pos
    k_pe32 = k_pe.float()
    if absorb:
        # q' = q_nope @ w_uk  -> latent space: (B, 1, H, kv_lora)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"])
        c32 = c_kv.float()
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c32)
             + torch.einsum("bshr,btr->bhst", q_rope.float(), k_pe32)) \
            * scale
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p, c32)     # latent context
        o = torch.einsum("bshr,rhk->bshk", ctx.to(x.dtype), params["w_uv"])
    else:
        k_nope = _project(c_kv, params["w_uk"])          # (B, S_max, H, n)
        v = _project(c_kv, params["w_uv"])               # (B, S_max, H, v)
        s = (torch.einsum("bshn,bthn->bhst", q_nope.float(), k_nope.float())
             + torch.einsum("bshn,btn->bhst", q_rope.float(), k_pe32)) \
            * scale
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhst,bthk->bshk", p, v.float()).to(x.dtype)
    return _out(o, params["w_o"]), cache
