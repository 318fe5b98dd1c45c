"""Flash attention of the port's LM with a recompute-based backward (the
reference's ``repro/models/flash.py``).

Forward: on CUDA tensors :func:`flash_attention` launches kernel E
(:func:`repro_torch.kernels.flash_attention.flash_attention_fwd`); on CPU
tensors it runs :func:`_fwd_pass`, the reference's blockwise online-
softmax algorithm over the statically enumerated (q block, kv block)
pairs, as plain tensor code.  The scale multiplies the q·k product, as
here in the reference (its Pallas kernel scales q instead).

Backward: where autograd records, the call goes through
:class:`FlashAttentionFunction`, which takes the place of the
reference's ``custom_vjp``: the forward keeps only (q, k, v, out, m, l),
the per-row float32 softmax statistics coming from kernel E itself on
the card, and the backward is :func:`_bwd_pass`, the reference's
recompute over the same block pairs, as torch ops in float32 on every
device (the reference has no Pallas backward either).
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
        mask = _mask(qi, kj, q_pos, k_pos, q_block, kv_block, seq_offset,
                     causal, window)
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


def _mask(qi, kj, q_pos, k_pos, q_block, kv_block, seq_offset, causal,
          window):
    """(1, q_block, 1, 1, kv_block) bool: which (query, key) pairs of
    block pair (qi, kj) the mask leaves visible, in absolute positions."""
    qp = qi * q_block + q_pos + seq_offset
    kp = kj * kv_block + k_pos
    mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window:
        mask &= kp[None, :] > qp[:, None] - window
    return mask[None, :, None, None, :]


def _bwd_pass(q, k, v, out, m, l, dout, pairs, *, causal, window,
              logit_softcap, q_block, kv_block, scale):
    """Gradients (dq, dk, dv) in q's, k's and v's dtypes: the scores and
    probabilities recomputed a block pair at a time from q, k and the
    saved statistics, in float32 (the reference's ``_bwd_pass``)."""
    b, sq, h, dh = q.shape
    _, skv, kv_heads, dv = v.shape
    g = h // kv_heads
    n_q = sq // q_block
    n_kv = skv // kv_block
    seq_offset = skv - sq

    qb = q.reshape(b, n_q, q_block, kv_heads, g, dh).float()
    kb = k.reshape(b, n_kv, kv_block, kv_heads, dh).float()
    vb = v.reshape(b, n_kv, kv_block, kv_heads, dv).float()
    do = dout.reshape(b, n_q, q_block, kv_heads, g, dv).float()
    ob = out.reshape(b, n_q, q_block, kv_heads, g, dv).float()
    mb = m.reshape(b, n_q, q_block, kv_heads, g)
    lb = l.reshape(b, n_q, q_block, kv_heads, g)
    # delta_i = sum_d do_i * o_i  (per row)
    delta = (do * ob).sum(dim=-1)

    dq = torch.zeros_like(qb)
    dk = torch.zeros_like(kb)
    dv_ = torch.zeros_like(vb)
    q_pos = torch.arange(q_block, device=q.device)
    k_pos = torch.arange(kv_block, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    for qi, kj in pairs:
        qblk, kblk, vblk, doblk = qb[:, qi], kb[:, kj], vb[:, kj], do[:, qi]
        mblk, lblk = mb[:, qi], lb[:, qi]
        s = torch.einsum("bqkgd,btkd->bqkgt", qblk, kblk) * scale
        if logit_softcap:
            t = torch.tanh(s / logit_softcap)
            s = logit_softcap * t
        mask = _mask(qi, kj, q_pos, k_pos, q_block, kv_block, seq_offset,
                     causal, window)
        m_safe = torch.where(mblk <= NEG_INF / 2, zero, mblk)
        l_safe = torch.clamp_min(lblk, 1e-30)
        p = torch.exp(s - m_safe[..., None]) / l_safe[..., None]
        p = torch.where(mask, p, zero)
        dp = torch.einsum("bqkgd,btkd->bqkgt", doblk, vblk)
        ds = p * (dp - delta[:, qi][..., None])
        if logit_softcap:
            ds = ds * (1.0 - t.square())
        ds = ds * scale
        dq[:, qi] += torch.einsum("bqkgt,btkd->bqkgd", ds, kblk)
        dk[:, kj] += torch.einsum("bqkgt,bqkgd->btkd", ds, qblk)
        dv_[:, kj] += torch.einsum("bqkgt,bqkgd->btkd", p, doblk)

    return (dq.reshape(b, sq, h, dh).to(q.dtype),
            dk.reshape(b, skv, kv_heads, dh).to(k.dtype),
            dv_.reshape(b, skv, kv_heads, dv).to(v.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """The reference's flash ``custom_vjp`` (``_make_flash``): the
    forward is kernel E with its softmax statistics on CUDA tensors and
    :func:`_fwd_pass` on CPU tensors; it saves (q, k, v, out, m, l); the
    backward is :func:`_bwd_pass` on the same block pairs."""

    @staticmethod
    def forward(ctx, q, k, v, pairs, kw):
        if q.device.type == "cuda":
            out, m, l = flash_attention_fwd(
                q, k, v, causal=kw["causal"], window=kw["window"],
                logit_softcap=kw["logit_softcap"], scale=kw["scale"],
                return_stats=True, blocks=(kw["q_block"], kw["kv_block"]))
        elif q.device.type == "cpu":
            out, m, l = _fwd_pass(q, k, v, pairs, **kw)
        else:
            raise ValueError(f"flash_attention runs on cuda or cpu, not "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.pairs, ctx.kw = pairs, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _bwd_pass(q, k, v, out, m, l, dout.contiguous(),
                               ctx.pairs, **ctx.kw)
        return dq, dk, dv, None, None


def blockwise_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                  logit_softcap: float = 0.0, scale: float | None = None,
                  return_stats: bool = False,
                  blocks: tuple[int, int] = (512, 512)):
    """Kernel E's function as the reference's blockwise plain version:
    :func:`_fwd_pass` over the static pairs of ``blocks`` (clipped to
    the sequences), with kernel E's wrapper's arguments and results.
    It is the twin whose work a count credits to a launch of E."""
    sq, skv = q.shape[1], k.shape[1]
    q_block, kv_block = min(blocks[0], sq), min(blocks[1], skv)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    pairs = _block_pairs(sq // q_block, skv // kv_block, q_block, kv_block,
                         skv - sq, bool(causal), int(window))
    out, m, l = _fwd_pass(q, k, v, pairs, causal=causal, window=window,
                          logit_softcap=logit_softcap, q_block=q_block,
                          kv_block=kv_block, scale=scale)
    return (out, m, l) if return_stats else out


def flash_attention_vjp(q, k, v, *, causal, window, logit_softcap, q_block,
                        kv_block, scale) -> torch.Tensor:
    """:func:`flash_attention` where autograd records: through
    :class:`FlashAttentionFunction` over the statically enumerated block
    pairs."""
    sq, skv = q.shape[1], k.shape[1]
    pairs = _block_pairs(sq // q_block, skv // kv_block, q_block, kv_block,
                         skv - sq, bool(causal), int(window))
    kw = dict(causal=bool(causal), window=int(window),
              logit_softcap=float(logit_softcap), q_block=q_block,
              kv_block=kv_block, scale=scale)
    return FlashAttentionFunction.apply(q, k, v, pairs, kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, q_block: int = 512,
                    kv_block: int = 512, scale: float | None = None,
                    p_bf16: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh) with H = g·KV.  Returns
    (B, Sq, H, Dv) in q's dtype.  Kernel E on the card, the blockwise
    plain version on the CPU; with a ``grad_fn`` (the recompute
    backward) where autograd records."""
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
            "kernel-redesign queue (ROADMAP Queue 2), with tensor-core tiles")
    scale = float(scale if scale is not None else dh ** -0.5)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_vjp(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap,
                                   q_block=q_block, kv_block=kv_block,
                                   scale=scale)
    fwd = flash_attention_fwd if q.device.type == "cuda" else blockwise_fwd
    return fwd(q, k, v, causal=causal, window=window,
               logit_softcap=logit_softcap, scale=scale,
               blocks=(q_block, kv_block))
