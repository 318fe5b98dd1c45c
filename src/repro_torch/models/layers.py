"""Elementary layers of the port's LM: norms, RoPE and M-RoPE, FFNs,
embeddings, softcap (the reference's ``repro/models/layers.py``).

Parameters are plain dicts of tensors in the reference's layouts.  Math
that the reference does in float32 (norms, RoPE, softcaps) is done in
float32 here and cast back to the input's dtype, as it does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._sharded import is_dtensor
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_op

from .common import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r} is not one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[cfg.dtype]


def normal(shape, std: float, dtype, generator, device) -> torch.Tensor:
    """``N(0, 1) * std`` drawn in float32 from ``generator`` on
    ``device``, cast to ``dtype`` (the reference's init idiom).  The
    product is taken in place: one float32 temporary, not two.  On the
    ``meta`` device nothing is drawn: an empty tensor of the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with (1+scale) parameterization, through kernel D on the
    card (its plain version on the CPU); differentiable on both (kernel
    D's autograd Function, whose backward is torch ops)."""
    return rmsnorm_op(x.contiguous(), params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer.  The two halves of D
    rotate together (``jnp.split``, not interleaved); f32 math."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (D/2,)
    ang = positions.float()[..., None] * freqs                 # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: tuple, device: torch.device) -> torch.Tensor:
    """(half,) index of the position stream (0 t, 1 h, 2 w) each
    frequency takes, made once a device: a copy to the card inside a
    forward would wait on its stream."""
    ids = torch.repeat_interleave(torch.arange(len(sections)),
                                  torch.tensor(sections))
    return ids.to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the half-dim frequency bands are split
    into (temporal, height, width) ``sections``, each rotated by its own
    position stream; f32 math, the halves rotated as :func:`apply_rope`.

    x: (B, S, H, D); positions3: (3, B, S) integer.
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (half,)
    sec_id = _section_ids(tuple(sections), x.device)           # (half,)
    pos = positions3.float().index_select(0, sec_id)           # (half, B, S)
    ang = pos.permute(1, 2, 0) * freqs                         # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Softcap (Gemma-2)
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in float32, cast back.  Without autograd
    a float32 copy is updated in place: on gemma2-2b's (1, 8192, 256000)
    logits it is 8.4 GB, and out-of-place ops would hold three of them
    at once.  Where autograd records, the same ops run out of place (the
    tanh's backward reads its output, which the in-place product would
    overwrite), and on a DTensor (an in-place op cannot keep a partial
    placement)."""
    if not cap:
        return x
    if torch.is_grad_enabled() and x.requires_grad or is_dtensor(x):
        return (torch.tanh(x.float() / cap) * cap).to(x.dtype)
    y = x.to(torch.float32, copy=True)
    return y.div_(cap).tanh_().mul_(cap).to(x.dtype)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------


def dense_ffn_init(d: int, d_ff: int, kind: str, dtype, generator,
                   device) -> dict:
    s_in, s_out = d ** -0.5, d_ff ** -0.5
    p = {}
    if kind == "swiglu":
        p["w_gate"] = normal((d, d_ff), s_in, dtype, generator, device)
    p["w_up"] = normal((d, d_ff), s_in, dtype, generator, device)
    p["w_down"] = normal((d_ff, d), s_out, dtype, generator, device)
    return p


def dense_ffn(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_init(vocab: int, d: int, dtype, generator, device) -> dict:
    return {"table": normal((vocab, d), d ** -0.5, dtype, generator, device)}


def embed(params: dict, tokens: torch.Tensor, scale: bool,
          d: int) -> torch.Tensor:
    x = params["table"][tokens.long()]
    if scale:
        # The reference multiplies by jnp.asarray(d ** 0.5, x.dtype): the
        # factor is rounded to the table's dtype first (48 exactly at
        # gemma2-2b's d = 2304, but 11.3125, not 11.3137, in bf16 at the
        # reduced d = 128).  Rounded on the host: a device scalar would
        # be a host-to-device copy on every call.
        x = x * float(torch.tensor(math.sqrt(d), dtype=x.dtype))
    return x


def unembed_init(vocab: int, d: int, dtype, generator, device) -> dict:
    return {"w": normal((d, vocab), d ** -0.5, dtype, generator, device)}


def unembed(params: Optional[dict], x: torch.Tensor, cap: float = 0.0,
            tied_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits in the compute dtype; the final softcap (gemma2-2b: 30) runs
    in float32 on them and is cast back, as in the reference."""
    logits = x @ tied_table.T if tied_table is not None else x @ params["w"]
    return softcap(logits, cap)
