"""Public flash-attention forward of the port (the reference's
``repro/kernels/flash_attention/ops.py``): kernel E on the card, its
plain version on the CPU."""

from __future__ import annotations

import torch

from .kernel import flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, block_q: int = 256,
                    block_kv: int = 512,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention, q (B, Sq, H, D), k (B, Skv, KV, D) and v (B, Skv,
    KV, Dv), out (B, Sq, H, Dv); the reference's arguments but
    ``interpret``, which has no meaning here.
    ``block_q`` and ``block_kv`` must tile the sequences, as the
    reference requires; kernel E chooses its own tiles
    (:func:`.kernel.plan`), so they change nothing else."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} q heads are not a multiple of {kvh} kv heads")
    if sq % min(block_q, sq) or skv % min(block_kv, skv):
        raise ValueError(f"blocks ({block_q}, {block_kv}) do not tile "
                         f"(Sq, Skv) = ({sq}, {skv})")
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap, scale=scale)
