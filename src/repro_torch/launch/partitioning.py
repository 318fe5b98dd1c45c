"""Parameter/input/cache sharding rules for the production meshes (the
reference's ``repro/launch/partitioning.py``).

Logical plan:
* batch dims ride ("pod", "data") (all pod+data axes present in the mesh);
* feature/head/expert/vocab dims ride "model" (tensor/expert parallelism);
* large weights additionally shard a second dim over "data" (FSDP-style
  2D sharding) so optimizer state for the 100B+ cells fits per-chip HBM;
* decode KV caches shard the sequence dim over "model" (and over "data"
  too when the batch can't use it, e.g. ``long_500k`` with batch 1).

Rules are name-based with a divisibility check; any dim not divisible by
its axis size is replicated (recorded by ``explain()``).

The layouts differ from the reference's in one way.  The reference
stacks each pattern position's parameters (and decode caches) over the
R repeats of the block pattern, ``blocks/{p}/...`` with a leading R dim
that no rule shards; the port keeps one dict a layer, ``layers/{i}/...``
(the prologue's ``pre_{i}`` are its first ``first_k_dense`` layers),
with no stacked dim.  So a port layer's spec is the reference's spec
without its leading ``None``.  The FSDP threshold reads the reference's
leaf, the stacked one: a pattern layer's bytes count R times
(``repeats``), the prologue's once.

A spec is the reference's ``PartitionSpec`` as a tuple (one entry a
tensor dim: ``None``, an axis name or a tuple of axis names);
:class:`Sharding` pairs one with its mesh, the counterpart of a
``NamedSharding``, and gives its DTensor ``placements``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional

from repro_torch.models.sharding import to_placements  # noqa: F401

from .mesh import axis_sizes

# params above this size get a second (FSDP) shard dim over "data"
FSDP_THRESHOLD_BYTES = 32 * (1 << 20)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def batch_axes(mesh) -> tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(n for n in ("pod", "data") if n in names)


def _axsize(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


# name-pattern -> index of the dim (negative = from the end) to put on
# "model".  Applied to the *unstacked* trailing dims.
_MODEL_DIM_RULES: list[tuple[str, Optional[int]]] = [
    (r"embed/table$", -2),          # (V, d) -> vocab
    (r"unembed/w$", -1),            # (d, V) -> vocab
    (r"w_q$", -2), (r"w_k$", -2), (r"w_v$", -2),   # (d, H, hd) -> heads
    (r"b_q$", -2), (r"b_k$", -2), (r"b_v$", -2),   # (H, hd)
    (r"w_o$", -3),                  # (H, hd, d) -> heads
    (r"w_gate$", -1), (r"w_up$", -1),   # (d, f) / (E, d, f) -> f
    (r"w_down$", -2),               # (f, d) / (E, f, d) -> f
    (r"in_proj$", -1), (r"out_proj$", -2),         # mamba
    (r"conv_w$", -1), (r"conv_b$", -1),
    (r"w_bcdt$", -2), (r"dt_proj$", -1), (r"dt_bias$", -1),
    (r"A_log$", -2), (r"/D$", -1),
    (r"w_dq$", -1), (r"w_uq$", -2),                # MLA
    (r"w_dkv$", -1), (r"w_kr$", -1),
    (r"w_uk$", -2), (r"w_uv$", -2),
    (r"router$", None),             # replicated (tiny, fp32)
]

# MoE expert tensors: expert dim (first trailing dim) on "model".
_EXPERT_RE = re.compile(r"ffn/(w_gate|w_up|w_down)$")
_NORM_RE = re.compile(r"(norm|scale|b_ig|b_fg|b_z|b_i|b_f|b_o)")


def param_spec(mesh, path: str, leaf, repeats: int = 1) -> tuple:
    """The spec of the parameter at ``path`` ("layers/3/mixer/w_q"):
    ``leaf`` its tensor (shape and dtype), ``repeats`` how many layers
    the reference's stacked leaf holds (R for a pattern layer, 1
    otherwise)."""
    path_s = path
    shape = tuple(leaf.shape)
    ndim = len(shape)
    model_n = _axsize(mesh, "model")
    data_n = _axsize(mesh, "data")
    spec: list = [None] * ndim

    if _NORM_RE.search(path_s) or ndim == 0:
        return tuple(spec)

    # --- choose the model dim ---
    model_dim: Optional[int] = None
    if _EXPERT_RE.search(path_s):
        model_dim = 0  # expert dim
    else:
        for pat, rel in _MODEL_DIM_RULES:
            if re.search(pat, path_s):
                if rel is None:
                    return tuple(spec)     # explicitly replicated
                cand = ndim + rel
                if cand >= 0:
                    model_dim = cand
                break
    if model_dim is None:
        # fallback: largest trailing dim divisible by model axis
        cands = [i for i in range(ndim) if shape[i] % model_n == 0]
        if cands:
            model_dim = max(cands, key=lambda i: shape[i])
    if model_dim is not None and shape[model_dim] % model_n == 0 \
            and model_n > 1:
        spec[model_dim] = "model"
    else:
        model_dim = None

    # --- FSDP second dim over "data" for large tensors ---
    size_bytes = repeats * math.prod(shape) * _itemsize(leaf.dtype)
    if data_n > 1 and size_bytes >= FSDP_THRESHOLD_BYTES:
        cands = [i for i in range(ndim)
                 if i != model_dim and shape[i] % data_n == 0]
        if cands:
            if _EXPERT_RE.search(path_s):
                # experts: FSDP the *contraction* dim (d for w_up/w_gate,
                # f for w_down = always the dim right after the expert
                # dim) so the partial-sum MoE path contracts locally and
                # never gathers weights (see models/moe.py).
                fsdp_dim = min(cands)
            else:
                fsdp_dim = max(cands, key=lambda i: shape[i])
            spec[fsdp_dim] = "data"
    return tuple(spec)


def with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over ``tree``'s leaves, rebuilding its
    structure; a path joins dict keys, sequence indices and named-tuple
    fields with "/", as the reference's key paths print."""
    if tree is None:
        return None
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: with_paths(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        fields = getattr(type(tree), "_fields", None)
        vals = [with_paths(fn, v, join(fields[i] if fields else i))
                for i, v in enumerate(tree)]
        return type(tree)._make(vals) if fields else type(tree)(vals)
    return fn(prefix, tree)


def _layer_repeats(cfg, path: str) -> int:
    m = re.match(r"layers/(\d+)/", path)
    if cfg is None or m is None or int(m.group(1)) < cfg.first_k_dense:
        return 1
    return cfg.num_pattern_repeats


def params_shardings(mesh, params_shapes, cfg=None) -> Any:
    """:class:`Sharding` tree for a params tree."""
    return with_paths(lambda path, leaf: Sharding(mesh, param_spec(
        mesh, path, leaf, _layer_repeats(cfg, path))), params_shapes)


def explain(mesh, params_shapes, cfg=None) -> list[str]:
    """Human-readable sharding decisions incl. replication fallbacks."""
    lines = []

    def visit(path, leaf):
        spec = param_spec(mesh, path, leaf, _layer_repeats(cfg, path))
        lines.append(f"{path:60s} {str(tuple(leaf.shape)):24s} "
                     f"-> {spec}")
        return leaf

    with_paths(visit, params_shapes)
    return lines


# ---------------------------------------------------------------------------
# Inputs / caches
# ---------------------------------------------------------------------------


def _batch_leaf_spec(mesh, path: str, leaf) -> tuple:
    baxes = batch_axes(mesh)
    full = math.prod(axis_sizes(mesh)[a] for a in baxes)
    nd = len(leaf.shape)
    if nd == 0:
        return ()
    if "positions" in path and nd == 3:   # (3, B, S)
        ok = leaf.shape[1] % full == 0
        return (None, baxes if ok else None, None)
    spec = [None] * nd
    if leaf.shape[0] % full == 0:
        spec[0] = baxes
    return tuple(spec)


def batch_pspec(mesh, batch_shapes) -> Any:
    """Raw specs for a Batch (tokens/embeds/positions/labels)."""
    return with_paths(lambda path, leaf: _batch_leaf_spec(mesh, path, leaf),
                      batch_shapes)


def batch_spec(mesh, batch_shapes) -> Any:
    """:class:`Sharding` s for a Batch."""
    return with_paths(lambda path, leaf: Sharding(
        mesh, _batch_leaf_spec(mesh, path, leaf)), batch_shapes)


def cache_spec(mesh, cache_shapes, global_batch: int) -> Any:
    """Decode-cache shardings.

    The batch dim shards over the batch axes when divisible; the
    sequence dim of KV caches shards over "model" (plus any batch axes
    the batch couldn't use — the ``long_500k`` batch=1 case).  SSM
    states shard their feature dim over "model".  The port's caches are
    one a layer (``{"layers": [...]}``), the reference's stacked (R, B,
    ...): a layer's spec is the stacked one's without its leading dim.
    """
    baxes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    # batch shardable only if divisible by the full batch-axes product
    full = 1
    for a in baxes:
        full *= sizes[a]
    batch_ok = global_batch % full == 0
    leftover = () if batch_ok else baxes   # give unused axes to seq dim

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd == 0:
            return Sharding(mesh, tuple(spec))
        if batch_ok:
            spec[0] = baxes
        # KV caches: (B, S, KV, hd) / MLA (B, S, r): shard S
        is_kv = nd >= 3 and shape[1] > 1024
        if is_kv:
            seq_axes = tuple(leftover) + ("model",)
            n = 1
            for a in seq_axes:
                n *= sizes[a]
            if shape[1] % n == 0:
                spec[1] = seq_axes
        else:
            # SSM state: shard the largest model-divisible trailing dim
            model_n = sizes.get("model", 1)
            cands = [i for i in range(1, nd)
                     if shape[i] % model_n == 0 and shape[i] >= model_n]
            if cands and model_n > 1:
                spec[max(cands, key=lambda i: shape[i])] = "model"
        return Sharding(mesh, tuple(spec))

    return with_paths(spec_for, cache_shapes)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())
