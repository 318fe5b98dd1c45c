"""Flash attention of the port's LM, forward only (the reference's
``repro/models/flash.py``).

On CUDA tensors :func:`flash_attention` launches kernel E
(:func:`repro_torch.kernels.flash_attention.flash_attention_fwd`); on CPU
tensors it runs :func:`_fwd_pass`, the reference's blockwise online-
softmax algorithm over the statically enumerated (q block, kv block)
pairs, as plain tensor code.  The scale multiplies the q·k product, as
here in the reference (its Pallas kernel scales q instead).

The reference wraps this in a recompute-based custom VJP for training;
the port's forward refuses a call that needs a gradient until the
training slice brings the backward pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd

from .attention import NEG_INF, _block_pairs


def _fwd_pass(q, k, v, pairs, *, causal, window, logit_softcap, q_block,
              kv_block, scale):
    """Returns (out (B,S,H,Dv), m (B,S,KV,g), l (B,S,KV,g)) — fp32 stats."""
    b, sq, h, dh = q.shape
    _, skv, kv_heads, dv = v.shape
    g = h // kv_heads
    n_q = sq // q_block
    seq_offset = skv - sq

    qb = q.reshape(b, n_q, q_block, kv_heads, g, dh)
    kb = k.reshape(b, skv // kv_block, kv_block, kv_heads, dh)
    vb = v.reshape(b, skv // kv_block, kv_block, kv_heads, dv)

    o = torch.zeros((b, n_q, q_block, kv_heads, g, dv), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, n_q, q_block, kv_heads, g), NEG_INF,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_q, q_block, kv_heads, g), dtype=torch.float32,
                    device=q.device)
    q_pos = torch.arange(q_block, device=q.device)
    k_pos = torch.arange(kv_block, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    for qi, kj in pairs:
        s = torch.einsum("bqkgd,btkd->bqkgt", qb[:, qi].float(),
                         kb[:, kj].float()) * scale
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        qp = qi * q_block + q_pos + seq_offset
        kp = kj * kv_block + k_pos
        mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp[None, :] <= qp[:, None]
        if window:
            mask &= kp[None, :] > qp[:, None] - window
        mask = mask[None, :, None, None, :]
        s = s.masked_fill(~mask, NEG_INF)
        m_old, l_old = m[:, qi], l[:, qi]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        # guard fully-masked rows (m_new == NEG_INF)
        m_safe = torch.where(m_new <= NEG_INF / 2, zero, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), zero)
        alpha = torch.where(m_old <= NEG_INF / 2, zero,
                            torch.exp(m_old - m_safe))
        l[:, qi] = l_old * alpha + p.sum(dim=-1)
        o[:, qi] = o[:, qi] * alpha[..., None] + torch.einsum(
            "bqkgt,btkd->bqkgd", p, vb[:, kj].float())
        m[:, qi] = m_new

    o = o / torch.clamp_min(l[..., None], 1e-30)
    out = o.reshape(b, sq, h, dv).to(q.dtype)
    return out, m.reshape(b, sq, kv_heads, g), l.reshape(b, sq, kv_heads, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, q_block: int = 512,
                    kv_block: int = 512, scale: float | None = None,
                    p_bf16: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh) with H = g·KV.  Returns
    (B, Sq, H, Dv) in q's dtype.  Kernel E on the card, the blockwise
    plain version on the CPU."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    if sq % q_block or skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) do not tile "
                         f"(Sq, Skv) = ({sq}, {skv})")
    if p_bf16:
        raise NotImplementedError(
            "p_bf16 (bf16 probabilities in the p@v product) comes with the "
            "kernel-redesign queue (ROADMAP Queue 4), with tensor-core tiles")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention backward (the reference's custom VJP) "
            "comes with the training slice of the LM port (ROADMAP Queue 1 "
            "item 12); call the forward under torch.no_grad()")
    scale = float(scale if scale is not None else dh ** -0.5)
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    pairs = _block_pairs(sq // q_block, skv // kv_block, q_block, kv_block,
                         skv - sq, bool(causal), int(window))
    out, _, _ = _fwd_pass(q, k, v, pairs, causal=causal, window=window,
                          logit_softcap=logit_softcap, q_block=q_block,
                          kv_block=kv_block, scale=scale)
    return out
