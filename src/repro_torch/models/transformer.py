"""Transformer assembly of the port's LM: stacks of GQA or MLA
attention, Mamba, mLSTM and sLSTM blocks with dense or MoE FFNs and the
dense prologue (the reference's ``repro/models/transformer.py``).

The reference runs ``first_k_dense`` unscanned prologue layers
(``params["pre_{i}"]``), then scans (``lax.scan``) over ``R`` repeats of
the config's ``block_pattern`` with per-position parameters stacked
along a leading repeat axis.  The port keeps one parameter dict a layer
and loops over the layers in order: the first ``first_k_dense`` are the
prologue's dense layers (of kind ``block_pattern[0]``), and layer ``i``
after them is pattern position ``(i - first_k_dense) % P`` of repeat
``(i - first_k_dense) // P``.  :func:`params_from_jax` carries the
reference's pytree across.  Which pattern position runs MoE is the
reference's :func:`_pattern_moe_flags`: by position, the same in every
repeat.

Public API:
    init_params(cfg, generator, device)     -> params
    forward(cfg, params, batch)             -> logits (B, S, V)
    loss_fn(cfg, params, batch, remat)      -> scalar loss (chunked xent
                                               + the MoE aux loss)
    init_cache(cfg, batch, max_len, dtype, device) -> decode cache
    decode_step(cfg, params, cache, batch, pos, mla_absorb)
                                            -> (logits, cache)

On the card every norm runs kernel D (MLA's ``q_norm`` and ``kv_norm``
too) and every full-sequence attention kernel E, in training too (their
autograd Functions' backwards are torch ops); decode attention (GQA's
and MLA's, naive or absorbed), the MoE block (:mod:`.moe`) and the SSM
blocks (:mod:`.ssm`) are plain tensor code, as in the reference.
Without RoPE (``use_rope=False``, Jamba, MusicGen) sinusoidal positions
are added to the embeddings; with ``mrope_sections`` (Qwen2-VL) q and k
rotate by M-RoPE over (3, B, S) t/h/w positions, (B, S) ones standing
for t = h = w.  A modality-stub config (``frontend_stub``) takes
precomputed frontend embeddings (``Batch.embeds``) or, as the reference,
token ids through its table.  Sequence parallelism comes with a later
slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sweep import resolve_device
from repro_torch.tree import tree_map

from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .common import ModelConfig
from .layers import (compute_dtype, dense_ffn, dense_ffn_init, embed,
                     embedding_init, rmsnorm, rmsnorm_init, unembed,
                     unembed_init)

#: What later slices bring: (message, ROADMAP Queue 1 item).
_LATER = {
    "seq_parallel": ("sequence parallelism comes with the sharding slice "
                     "of the LM port", "12g"),
}

LOSS_CHUNK = 256     # sequence-chunked cross entropy (bounds logits memory)


def _later(what: str):
    msg, item = _LATER[what]
    return NotImplementedError(f"{msg} (ROADMAP Queue 1 item {item})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    if cfg.seq_parallel:
        raise _later("seq_parallel")


class Batch(NamedTuple):
    """Either token ids or precomputed frontend embeddings (modality
    stubs).

    tokens:    (B, S) integer, or None when ``embeds`` is given
    embeds:    (B, S, d_model) or None — vision patches / audio frames,
               cast to the compute dtype
    positions: (B, S) integer, or (3, B, S) t/h/w streams for M-RoPE, or
               None for 0..S-1
    labels:    (B, S) next-token targets (training only)
    """
    tokens: Optional[torch.Tensor] = None
    embeds: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Per-block init / forward / decode
# ---------------------------------------------------------------------------


def _block_init(cfg: ModelConfig, kind: str, use_moe: bool, dtype,
                generator, device) -> dict:
    d = cfg.d_model
    p: dict = {"norm1": rmsnorm_init(d, device)}
    if kind.startswith("attn"):
        p["mixer"] = (attn.mla_init(cfg, dtype, generator, device)
                      if cfg.attention_kind == "mla"
                      else attn.gqa_init(cfg, dtype, generator, device))
    elif kind == "mamba":
        p["mixer"] = ssm.mamba_init(cfg, dtype, generator, device)
    elif kind == "mlstm":
        p["mixer"] = ssm.mlstm_init(cfg, dtype, generator, device)
    elif kind == "slstm":
        p["mixer"] = ssm.slstm_init(cfg, dtype, generator, device)
    else:
        raise ValueError(kind)
    # the xLSTM blocks hold their projections: no FFN beside them
    has_ffn = use_moe or (cfg.d_ff > 0 and kind not in ("mlstm", "slstm"))
    if has_ffn:
        p["norm2"] = rmsnorm_init(d, device)
        p["ffn"] = (moe_mod.moe_init(cfg, dtype, generator, device)
                    if use_moe
                    else dense_ffn_init(d, cfg.d_ff, cfg.ffn_kind, dtype,
                                        generator, device))
    if cfg.post_block_norm:
        p["post_norm1"] = rmsnorm_init(d, device)
        if has_ffn:
            p["post_norm2"] = rmsnorm_init(d, device)
    return p


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "attn_local" else 0


def _ffn_half(cfg: ModelConfig, use_moe: bool, params: dict,
              x: torch.Tensor, train: bool) -> tuple:
    """The FFN half of a block: (x, aux), aux None without MoE (the
    reference's zero)."""
    if "ffn" not in params:
        return x, None
    aux = None
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if use_moe:
        h, aux = moe_mod.moe_apply(cfg, params["ffn"], h, train=train)
    else:
        h = dense_ffn(params["ffn"], h, cfg.ffn_kind)
    if cfg.post_block_norm:
        h = rmsnorm(params["post_norm2"], h, cfg.norm_eps)
    return x + h, aux


def _mixer_forward(cfg: ModelConfig, kind: str, params: dict,
                   x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if kind.startswith("attn"):
        if cfg.attention_kind == "mla":
            return attn.mla_forward(cfg, params, x, positions)
        return attn.gqa_forward(cfg, params, x, positions,
                                window=_window(cfg, kind))
    if kind == "mamba":
        return ssm.mamba_forward(cfg, params, x)
    if kind == "mlstm":
        return ssm.mlstm_block_forward(cfg, params, x)
    if kind == "slstm":
        return ssm.slstm_block_forward(cfg, params, x)
    raise ValueError(kind)


def _block_forward(cfg: ModelConfig, kind: str, use_moe: bool,
                   params: dict, x: torch.Tensor,
                   positions: torch.Tensor) -> tuple:
    """Returns (x, aux_loss), aux_loss None for a block without MoE."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    h = _mixer_forward(cfg, kind, params["mixer"], h, positions)
    if cfg.post_block_norm:
        h = rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    return _ffn_half(cfg, use_moe, params, x + h, train=True)


def _block_init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype, device):
    """A layer's decode state: a KV cache for GQA, the compressed
    ``c_kv`` and ``k_pe`` cache for MLA, the O(1) state of an SSM
    block."""
    if kind.startswith("attn"):
        if cfg.attention_kind == "mla":
            return attn.mla_init_cache(cfg, batch, max_len, dtype, device)
        return attn.gqa_init_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return ssm.mamba_init_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return ssm.mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return ssm.slstm_init_state(cfg, batch, device)
    raise ValueError(kind)


def _block_decode(cfg: ModelConfig, kind: str, use_moe: bool, params: dict,
                  x: torch.Tensor, cache, pos: int,
                  mla_absorb: bool) -> tuple:
    """Returns (x, the layer's cache): a KV or MLA cache written in
    place, or an SSM block's new state.  ``mla_absorb`` picks MLA's
    absorbed step (GQA and the SSM blocks ignore it, as in the
    reference)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind.startswith("attn"):
        if cfg.attention_kind == "mla":
            h, cache = attn.mla_decode(cfg, params["mixer"], h, cache, pos,
                                       absorb=mla_absorb)
        else:
            h, cache = attn.gqa_decode(cfg, params["mixer"], h, cache, pos,
                                       window=_window(cfg, kind))
    elif kind == "mamba":
        h, cache = ssm.mamba_decode(cfg, params["mixer"], h, cache)
    elif kind == "mlstm":
        h, cache = ssm.mlstm_block_decode(cfg, params["mixer"], h, cache)
    elif kind == "slstm":
        h, cache = ssm.slstm_block_decode(cfg, params["mixer"], h, cache)
    else:
        raise ValueError(kind)
    if cfg.post_block_norm:
        h = rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    x, _ = _ffn_half(cfg, use_moe, params, x + h, train=False)
    return x, cache


def _pattern_moe_flags(cfg: ModelConfig) -> list[bool]:
    """Whether each pattern position uses MoE (consistent across repeats)."""
    flags = []
    for i, _ in enumerate(cfg.block_pattern):
        gidx = cfg.first_k_dense + i
        flags.append(cfg.layer_uses_moe(gidx))
    if cfg.moe is not None:
        # consistency across repeats requires pattern_len % every_k == 0
        assert len(cfg.block_pattern) % cfg.moe.every_k_layers == 0 or \
            cfg.moe.every_k_layers % len(cfg.block_pattern) == 0
    return flags


def layer_moe_flags(cfg: ModelConfig) -> list[bool]:
    """Whether each layer the reference builds runs MoE: the
    ``first_k_dense`` prologue layers never, then the ``R`` repeats of
    :func:`_pattern_moe_flags` (the flag of a pattern position, not
    ``cfg.layer_uses_moe`` of the layer)."""
    return ([False] * cfg.first_k_dense
             + _pattern_moe_flags(cfg) * cfg.num_pattern_repeats)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random weights with the reference's fan-in scales (norm scales 0,
    biases 0), drawn from ``generator`` (a generator on ``device``; by
    default one seeded with 0)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = compute_dtype(cfg)
    params: dict = {
        "embed": embedding_init(cfg.vocab_size, cfg.d_model, dtype,
                                generator, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = unembed_init(cfg.vocab_size, cfg.d_model, dtype,
                                         generator, dev)
    params["layers"] = [_block_init(cfg, cfg.layer_kind(i), use_moe, dtype,
                                    generator, dev)
                        for i, use_moe in enumerate(layer_moe_flags(cfg))]
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def to_device(params, device) -> dict:
    """A copy of ``params`` with every tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


def _from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as JAX hands it
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(cfg: ModelConfig, params: dict) -> dict:
    """Carry the reference's parameters (``repro.models.transformer.
    init_params``'s pytree, as numpy arrays) into this model's layout, on
    the CPU: the prologue's ``params["pre_{i}"]`` are layers ``i <
    first_k_dense``; ``params["blocks"]`` is a tuple over the P pattern
    positions, each stacked along a leading repeat axis R, and layer
    ``first_k_dense + j`` is repeat ``j // P`` at position ``j % P``.
    Dtypes are kept (norm scales, MLA's ``q_norm`` and ``kv_norm`` among
    them, the MoE router and the SSM blocks' gate, decay and skip leaves
    stay float32 in a bf16 model)."""
    check_supported(cfg)
    blocks = params["blocks"]
    pat, r = len(cfg.block_pattern), cfg.num_pattern_repeats
    if len(blocks) != pat:
        raise ValueError(f"{len(blocks)} stacked positions, pattern has "
                         f"{pat}")
    pre = [f"pre_{i}" for i in range(cfg.first_k_dense)]
    out = {k: tree_map(_from_numpy, v) for k, v in params.items()
           if k != "blocks" and k not in pre}
    layers = [tree_map(_from_numpy, params[k]) for k in pre]
    for j in range(r * pat):
        rep, posn = divmod(j, pat)

        def take(a, rep=rep):
            a = np.asarray(a)
            if a.shape[0] != r:
                raise ValueError(f"stacked leaf has {a.shape[0]} repeats, "
                                 f"config has {r}")
            return _from_numpy(a[rep])

        layers.append(tree_map(take, blocks[posn]))
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Forward (prompt)
# ---------------------------------------------------------------------------


def _default_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal position embedding (B, S) -> (B, S, d),
    float32: the sines of the first d/2 frequencies, then their
    cosines."""
    half = d // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _inputs_to_x(cfg: ModelConfig, params: dict,
                 batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
    if batch.embeds is not None:
        x = batch.embeds.to(compute_dtype(cfg))
        b, s = x.shape[:2]
    else:
        x = embed(params["embed"], batch.tokens, cfg.scale_embeddings,
                  cfg.d_model)
        b, s = batch.tokens.shape
    pos = batch.positions
    if pos is None:
        pos = _default_positions(b, s, x.device)
    if not cfg.use_rope:
        p2d = pos if pos.ndim == 2 else pos[0]
        x = x + _sinusoidal(p2d, cfg.d_model).to(x.dtype)
    return x, pos


def hidden_states(cfg: ModelConfig, params: dict, batch: Batch,
                  remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stack; returns (hidden (B,S,d) after the final norm,
    aux_loss), aux_loss the sum of the MoE layers' load-balancing losses
    (float32; 0 for dense stacks).

    ``remat=True`` runs each layer under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the whole layer, where the
    reference's ``jax.checkpoint`` keeps the matmul outputs (its
    dots-saveable policy).  Recomputation repeats the same operations on
    the same inputs, so the numbers are the same either way, but for the
    order in which a leaf used in several places (the tied embedding)
    sums its gradient's parts; memory and time differ (and on the card
    the recomputed layer launches kernels D and E again).
    """
    check_supported(cfg)
    x, positions = _inputs_to_x(cfg, params, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, use_moe) in enumerate(zip(params["layers"],
                                         layer_moe_flags(cfg))):
        kind = cfg.layer_kind(i)
        if remat:
            x, aux = checkpoint(_block_forward, cfg, kind, use_moe, p, x,
                                positions, use_reentrant=False)
        else:
            x, aux = _block_forward(cfg, kind, use_moe, p, x, positions)
        if aux is not None:
            aux_total = aux_total + aux
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux_total


def _logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    return unembed(params.get("unembed"), h, cfg.final_logit_softcap, tied)


def forward(cfg: ModelConfig, params: dict, batch: Batch) -> torch.Tensor:
    """Full logits (B, S, V) in the compute dtype."""
    h, _ = hidden_states(cfg, params, batch)
    return _logits(cfg, params, h)


def _chunk_loss(cfg: ModelConfig, params: dict, hb: torch.Tensor,
                lb: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy of one sequence chunk: its logits in float32,
    ``logsumexp`` minus the gold logit."""
    logits = _logits(cfg, params, hb).float()
    gold = logits.gather(-1, lb.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_fn(cfg: ModelConfig, params: dict, batch: Batch,
            remat: bool = False) -> torch.Tensor:
    """Sequence-chunked softmax cross entropy (float32 scalar).

    Never holds (B, S, V) logits: chunks of ``LOSS_CHUNK`` positions (or
    the largest power-of-two fraction of it that tiles S) each make
    their logits and logsumexp; the sum over chunks is divided by B·S,
    and the aux loss added.  With ``remat`` each chunk also runs under
    ``torch.utils.checkpoint``, so its float32 logits are recomputed in
    the backward instead of kept.
    """
    h, aux = hidden_states(cfg, params, batch, remat=remat)
    labels = batch.labels
    b, s, _ = h.shape
    chunk = min(LOSS_CHUNK, s)
    while s % chunk:
        chunk //= 2
    chunk = max(chunk, 1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        hb, lb = h[:, i:i + chunk], labels[:, i:i + chunk]
        if remat:
            part = checkpoint(_chunk_loss, cfg, params, hb, lb,
                              use_reentrant=False)
        else:
            part = _chunk_loss(cfg, params, hb, lb)
        total = total + part
    return total / (b * s) + aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """One decode state a layer (the prologue's ``pre_{i}`` first): a KV
    cache (zeros, in the compute dtype by default) for GQA, an
    ``MLACache`` for MLA, a ``MambaState``, ``MLSTMState`` or
    ``SLSTMState`` for an SSM block."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    return {"layers": [_block_init_cache(cfg, cfg.layer_kind(i), batch,
                                         max_len, dtype, dev)
                       for i in range(len(layer_moe_flags(cfg)))]}


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: Batch,
                pos: int, *, mla_absorb: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One-token step. batch.tokens: (B, 1) (or embeds (B, 1, d)).

    ``pos`` is the cache position to write (== number of tokens already in
    the cache).  Returns (logits (B, 1, V), cache): KV and MLA caches are
    updated in place, an SSM layer's entry replaced by its new state.
    Without RoPE and without ``batch.positions`` the token sits at
    ``pos``.  ``mla_absorb`` reaches every MLA layer, the prologue's
    included: the absorbed step instead of the naive one.
    """
    check_supported(cfg)
    pos = int(pos)
    if batch.positions is None and not cfg.use_rope:
        inp = batch.tokens if batch.tokens is not None else batch.embeds
        batch = batch._replace(positions=torch.full(
            (inp.shape[0], 1), pos, dtype=torch.int32, device=inp.device))
    x, _ = _inputs_to_x(cfg, params, batch)
    for i, (p, use_moe) in enumerate(zip(params["layers"],
                                         layer_moe_flags(cfg))):
        x, cache["layers"][i] = _block_decode(cfg, cfg.layer_kind(i),
                                              use_moe, p, x,
                                              cache["layers"][i], pos,
                                              mla_absorb)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x), cache
