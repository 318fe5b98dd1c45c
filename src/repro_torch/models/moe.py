"""Mixture-of-Experts FFN of the port's LM: top-k routing with
capacity-based dispatch (the reference's ``repro/models/moe.py``).

Dispatch is by index, as in the reference: tokens are grouped
(:func:`_group_tokens`), each token picks its top-k experts from a
float32 softmax of the router, each pick is ranked within its (group,
expert) by an exclusive cumulative count over the group's picks (token-
major, then k), and the picks ranked under the capacity
(:func:`_capacity`) are written into a static buffer of ``C`` slots an
(expert, group).  The experts run on that buffer; each token gathers its
kept picks back and weights them by its renormalised router
probabilities.  The compute is the active experts' times the capacity
factor, whatever the routes.

The buffer is the reference's (G, E, C, d) laid out expert-major, (E,
G·C, d), so the expert products (``gecd,edf->gecf``) are one batched
matmul over E on the weights as they are, with no copy of either.  A
kept (expert, group, slot) is unique, so writing the kept picks by
index equals the reference's scatter-add of zero-masked picks; a
dropped pick is written to one scratch row past the buffer, so no mask
is read back on the host (and no atomics run on the card).

Top-k follows ``jax.lax.top_k``: the k largest, ties to the lower
expert index (a stable descending sort, first k).

The reference's ``constrain`` calls place the buffer and the expert
products on a device mesh (:mod:`.sharding`): the buffer's experts over
"model" and its groups over the batch axes, or, with
``moe_partial_sum``, its ``d`` (and the products' ``f``) over "data",
where the experts' contraction dims are sharded (the FSDP rule of
``launch/partitioning.py``), so both expert products contract locally.
In the port's (E, G·C, d) layout the reference's (G, E, C, d) spec
``(BATCH, MODEL, None, None)`` is ``(MODEL, BATCH, None)``.  Without a
mesh they return their argument, so both settings compute the same
math.  ``train`` is accepted and changes nothing, as in the reference
(no router jitter).

Supports the reference's variants: Arctic (128 experts top-2 plus a
dense residual FFN in parallel), DeepSeek (routed plus always-on shared
experts), Jamba (MoE on every 2nd layer, set by the transformer).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, MoEConfig
from .layers import dense_ffn, dense_ffn_init, normal
from .sharding import BATCH, MODEL, constrain

GROUP_SIZE = 512     # tokens per routing group (training/prefill)


def _experts(shape, std: float, dtype, generator, device) -> torch.Tensor:
    """(E, ...) normals at ``std`` in ``dtype``, drawn one expert at a
    time into a preallocated tensor: the float32 draw a call is one
    expert's (140 MB at arctic-480b's 7168 x 4864), not all of them.
    On the ``meta`` device, an empty tensor of the shape."""
    w = torch.empty(shape, dtype=dtype, device=device)
    if w.device.type == "meta":
        return w
    for i in range(shape[0]):
        w[i] = normal(shape[1:], std, dtype, generator, device)
    return w


def moe_init(cfg: ModelConfig, dtype, generator, device) -> dict:
    m = cfg.moe
    assert m is not None
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": normal((d, e), s_in, torch.float32, generator, device),
        "w_gate": _experts((e, d, f), s_in, dtype, generator, device),
        "w_up": _experts((e, d, f), s_in, dtype, generator, device),
        "w_down": _experts((e, f, d), s_out, dtype, generator, device),
    }
    if m.num_shared_experts:
        p["shared"] = dense_ffn_init(d, f * m.num_shared_experts,
                                     cfg.ffn_kind, dtype, generator, device)
    if m.dense_residual:
        p["residual"] = dense_ffn_init(d, cfg.d_ff, cfg.ffn_kind, dtype,
                                       generator, device)
    return p


def _group_tokens(x2d: torch.Tensor, m: MoEConfig) -> tuple:
    """Reshape (T, d) -> (G, gs, d) with a capacity-friendly group size."""
    t = x2d.shape[0]
    gs = min(GROUP_SIZE, t)
    # groups must tile the token count
    while t % gs:
        gs //= 2
    gs = max(gs, 1)
    return x2d.reshape(t // gs, gs, x2d.shape[1]), gs


def _capacity(gs: int, m: MoEConfig) -> int:
    c = math.ceil(gs * m.top_k * m.capacity_factor / m.num_experts)
    return max(1, min(c, gs))


def _top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_top_k(x: torch.Tensor, router: torch.Tensor, k: int) -> tuple:
    """float32 router probabilities of ``x`` (..., d), and the top-k
    probabilities (renormalised to sum 1) and experts."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


class Routes(NamedTuple):
    """The routing of grouped tokens (G, gs, d)."""
    probs: torch.Tensor    # (G, gs, E) float32
    top_p: torch.Tensor    # (G, gs, k) float32, renormalised
    top_e: torch.Tensor    # (G, gs, k) expert of each pick
    pos: torch.Tensor      # (G, gs, k) rank of the pick in (group, expert)
    keep: torch.Tensor     # (G, gs, k) pos < capacity
    aux: torch.Tensor      # () float32 load-balancing loss


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor,
          cap: int) -> Routes:
    """Route grouped tokens ``xg`` (G, gs, d) at capacity ``cap``."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    g, gs, _ = xg.shape
    probs, top_p, top_e = _router_top_k(xg, router, k)

    # ---- aux load-balancing loss (Switch-style) ----
    me = probs.mean(dim=1)                                     # (G, E)
    ce = F.one_hot(top_e[..., 0], e).float().mean(dim=1)       # (G, E)
    aux = (me * ce).sum(-1).mean() * e * m.aux_loss_weight

    # ---- rank within (group, expert): position = #earlier picks of e ----
    flat = top_e.reshape(g, gs * k, 1)
    counts = F.one_hot(flat[..., 0], e).cumsum(dim=1)          # inclusive
    pos = (counts.gather(-1, flat) - 1).reshape(g, gs, k)
    return Routes(probs, top_p, top_e, pos, pos < cap, aux)


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
              train: bool = True) -> tuple:
    """x: (B, S, d). Returns (out (B, S, d), aux_loss () float32)."""
    m = cfg.moe
    assert m is not None
    b, s, d = x.shape
    e = m.num_experts
    xg, gs = _group_tokens(x.reshape(b * s, d), m)            # (G, gs, d)
    g = xg.shape[0]
    cap = _capacity(gs, m)
    r = route(cfg, params["router"], xg, cap)

    # ---- dispatch: buffer row (expert, group, slot) = (e·G + g)·C + slot
    n = e * g * cap
    gi = torch.arange(g, device=x.device)[:, None, None]
    row = (r.top_e * g + gi) * cap + r.pos
    dst = torch.where(r.keep, row, n)                  # drops: scratch row
    src = xg[:, :, None, :].expand(g, gs, m.top_k, d).reshape(-1, d)
    buf = x.new_zeros((n + 1, d)).index_copy(0, dst.reshape(-1), src)
    h = constrain(buf[:n].view(e, g * cap, d), MODEL, BATCH, None)

    # ---- expert FFN: one batched matmul over the experts ----
    ps = cfg.moe_partial_sum
    if ps:
        # reshard the buffer so groups gather while d shards over "data"
        # (the experts' contraction dims are "data"-sharded): both
        # expert products contract locally, no weight is gathered
        h = constrain(h, MODEL, None, "data")
    up = torch.bmm(h, params["w_up"])
    if ps:
        up = constrain(up, MODEL, None, "data")      # reduce-scatter f
    if cfg.ffn_kind == "swiglu":
        gate = F.silu(torch.bmm(h, params["w_gate"]))
        if ps:
            gate = constrain(gate, MODEL, None, "data")
        act = gate * up
    else:
        act = F.gelu(up, approximate="tanh")
    out = torch.bmm(act, params["w_down"])
    out = constrain(out, *((MODEL, None, "data") if ps
                           else (MODEL, BATCH, None))).reshape(n, d)

    # ---- combine: gather each token's k slots, weight by router prob ----
    gathered = out[torch.where(r.keep, row, 0)]               # (G, gs, k, d)
    gathered = torch.where(r.keep[..., None], gathered, 0)
    yg = torch.einsum("gskd,gsk->gsd", gathered, r.top_p.to(x.dtype))
    y = constrain(yg.reshape(b, s, d), BATCH, None, None)

    # ---- always-on branches ----
    if "shared" in params:
        y = y + dense_ffn(params["shared"], x, cfg.ffn_kind)
    if "residual" in params:
        y = y + dense_ffn(params["residual"], x, cfg.ffn_kind)
    return y, r.aux


def moe_ref(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts, no capacity.

    O(T * k * expert) memory via gathered per-token expert weights, so
    only usable at test sizes, but drop-free: validates ``moe_apply`` up
    to capacity drops.
    """
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    _, top_p, top_e = _router_top_k(x2d, params["router"], m.top_k)
    wg = params["w_gate"][top_e]        # (T, k, d, f)
    wu = params["w_up"][top_e]
    wd = params["w_down"][top_e]
    up = torch.einsum("td,tkdf->tkf", x2d, wu)
    if cfg.ffn_kind == "swiglu":
        h = F.silu(torch.einsum("td,tkdf->tkf", x2d, wg)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    yk = torch.einsum("tkf,tkfd->tkd", h, wd)
    y = torch.einsum("tkd,tk->td", yk, top_p.to(yk.dtype))
    y = y.reshape(b, s, d)
    if "shared" in params:
        y = y + dense_ffn(params["shared"], x, cfg.ffn_kind)
    if "residual" in params:
        y = y + dense_ffn(params["residual"], x, cfg.ffn_kind)
    return y
