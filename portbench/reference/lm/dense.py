"""Plain reference of a dense decoder-only language model: RMSNorm,
grouped-query attention with RoPE, a SwiGLU FFN and the logits, in
float32 with TF32 off, as plain torch operations.

The sizes are the configuration file's, under the keys of the model's
published ``config.json``: ``hidden_size``, ``intermediate_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim`` (else
hidden size over heads), ``num_hidden_layers``, ``vocab_size``,
``rms_norm_eps``, ``rope_theta`` and ``tie_word_embeddings``.

The weights are the benchmark's inputs (``portbench/lm_program.py``
draws them), in their layout: ``embed.table`` (V, d); a layer's
``norm1.scale`` and ``norm2.scale`` (d,), the norm's weight being ``1 +
scale``; ``mixer.w_q`` (d, H, Dh), ``w_k`` and ``w_v`` (d, KV, Dh),
``w_o`` (H, Dh, d); ``ffn.w_gate`` and ``w_up`` (d, F), ``w_down`` (F,
d); ``final_norm.scale``; ``unembed.w`` (d, V), or the table where the
embeddings are tied.  Each is read in its served type and widened to
float32 here.

RoPE rotates the two halves of each head (not interleaved pairs), at
``theta ** (-i / (Dh / 2))``.  A position attends to itself and every
earlier one, scaled by ``Dh ** -0.5``.  The forward runs a layer at a
time over blocks of positions, so that it fits beside the program's
weights at any prompt length.

``low=True`` is the control of ``correct``: every matrix product's
operands rounded to float8 e4m3 first (the weights a scale an output
column, the activations a scale a row, each scale the absolute maximum
over 448), the rest as above.
"""

from __future__ import annotations

import contextlib

import torch

#: The largest float8 e4m3 value.
E4M3_MAX = 448.0
#: Bytes of float32 attention scores a block of queries may take.
SCORE_BYTES = 1 << 30


def sizes(config: dict) -> dict:
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    return {"d": d, "h": h, "kv": int(config["num_key_value_heads"]),
            "dh": int(config.get("head_dim") or d // h),
            "f": int(config["intermediate_size"]),
            "layers": int(config["num_hidden_layers"]),
            "vocab": int(config["vocab_size"]),
            "eps": float(config["rms_norm_eps"]),
            "theta": float(config["rope_theta"]),
            "tied": bool(config.get("tie_word_embeddings", False))}


@contextlib.contextmanager
def exact_float32():
    """Matrix products in full float32 (TF32 off) inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """``x (..., n) @ w (n, m)`` in float32."""
    w = w.float()
    if low:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    r = torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return x * r * (1.0 + scale.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) at positions ``pos`` (S,)."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attend(q, k, v, start: int) -> torch.Tensor:
    """q (B, S, KV, G, Dh) at positions start.. ; k, v (B, T, KV, Dh) at
    0..T-1: causal attention, (B, S, KV, G, Dh)."""
    s = torch.einsum("bskgd,btkd->bkgst", q, k) * q.shape[-1] ** -0.5
    qpos = start + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return torch.einsum("bkgst,btkd->bskgd", torch.softmax(s, dim=-1), v)


def logits(config: dict, weights: dict, tokens: torch.Tensor, first: int,
           *, block: int = 512, low: bool = False) -> torch.Tensor:
    """Logits (B, S - first, V), float32, at positions ``first`` .. S-1
    of ``tokens`` (B, S): the full forward without a cache."""
    z = sizes(config)
    b, s = tokens.shape
    d, h, kv, dh = z["d"], z["h"], z["kv"], z["dh"]
    g = h // kv
    # queries a block: their scores within SCORE_BYTES
    blk = max(1, min(block, SCORE_BYTES // (4 * b * h * s)))
    with exact_float32(), torch.no_grad():
        x = weights["embed"]["table"][tokens.long()].float()
        pos = torch.arange(s, device=tokens.device)
        for layer in weights["layers"]:
            at, ffn = layer["mixer"], layer["ffn"]
            k_all = x.new_empty((b, s, kv, dh))
            v_all = x.new_empty((b, s, kv, dh))
            for a in range(0, s, blk):
                e = min(a + blk, s)
                hb = _norm(x[:, a:e], layer["norm1"]["scale"], z["eps"])
                q = _mm(hb, at["w_q"].reshape(d, h * dh), low)
                q = _rope(q.view(b, e - a, h, dh), pos[a:e], z["theta"])
                k = _mm(hb, at["w_k"].reshape(d, kv * dh), low)
                k_all[:, a:e] = _rope(k.view(b, e - a, kv, dh), pos[a:e],
                                      z["theta"])
                v_all[:, a:e] = _mm(hb, at["w_v"].reshape(d, kv * dh),
                                    low).view(b, e - a, kv, dh)
                o = _attend(q.view(b, e - a, kv, g, dh), k_all[:, :e],
                            v_all[:, :e], a)
                xb = x[:, a:e] + _mm(o.reshape(b, e - a, h * dh),
                                     at["w_o"].reshape(h * dh, d), low)
                hb = _norm(xb, layer["norm2"]["scale"], z["eps"])
                up = _mm(hb, ffn["w_up"], low)
                act = torch.nn.functional.silu(_mm(hb, ffn["w_gate"], low))
                x[:, a:e] = xb + _mm(act * up, ffn["w_down"], low)
        hf = _norm(x[:, first:], weights["final_norm"]["scale"], z["eps"])
        w = (weights["embed"]["table"].T if z["tied"]
             else weights["unembed"]["w"])
        return _mm(hf, w, low)


def token_flops(config: dict, context: int, with_logits: bool) -> int:
    """The frozen work of one token, two operations a multiply-add: its
    projections, attention's q.k and p.v over ``context`` positions (the
    token's own included) and its FFN in every layer, and the logits
    where ``with_logits``."""
    z = sizes(config)
    d, h, kv, dh, f = z["d"], z["h"], z["kv"], z["dh"], z["f"]
    layer = (2 * d * (h + 2 * kv) * dh + 2 * h * dh * d + 2 * 3 * d * f
             + 2 * 2 * h * dh * context)
    return z["layers"] * layer + (2 * d * z["vocab"] if with_logits else 0)
