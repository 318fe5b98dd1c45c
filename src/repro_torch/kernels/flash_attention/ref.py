"""Plain PyTorch attention (the reference's
``repro/kernels/flash_attention/ref.py``): the full softmax.

:func:`flash_attention_ref` is what kernel E (:mod:`.kernel`) is held
against on the card, and what its wrapper runs for CPU tensors.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def visible_mask(sq: int, skv: int, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees, in absolute positions
    (query i sits at ``i + skv - sq``)."""
    qpos = torch.arange(sq, device=device) + (skv - sq)
    kpos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0,
                        scale: float | None = None,
                        return_stats: bool = False):
    """q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv).  Full
    softmax attention in float32, returned (B, Sq, H, Dv) in q's dtype.  The scale multiplies the product.
    With ``return_stats`` also each row's float32 softmax statistics,
    (B, Sq, KV, g): ``m`` the largest visible score (NEG_INF where none
    is visible) and ``l`` the sum of ``exp(s - m)`` over the visible
    scores (0 where none), as the reference's ``_fwd_pass`` returns
    them."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqkgd,btkd->bqkgt", qg, k.float()) * scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = visible_mask(sq, skv, causal, window, q.device)
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgt,btkd->bqkgd", p, v.float())
    out = o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if not return_stats:
        return out
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    e = torch.exp(s - m_safe[..., None]).masked_fill(
        ~mask[None, :, None, None, :], 0.0)
    return out, m, e.sum(dim=-1)
