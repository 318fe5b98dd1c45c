"""AdamW with gradient clipping, cosine schedule and a configurable moment
dtype: the port of the reference ``repro.optim.adamw``, as functions over
trees (dicts, lists, tuples, named tuples; ``None`` an empty subtree) of
tensors (:mod:`repro_torch.tree`).

The update runs in float32 whatever the parameters' dtype, as the
reference's does: the global norm, the clip scale, the moments, the bias
corrections and the learning rate are float32, and a float64 parameter
is rounded to float32, updated there and widened back.  Every cast is
written out, and every constant is a float32 tensor: torch promotes a
0-dim operand and an n-dim one by other rules than JAX, so nothing here
leans on promotion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves as _leaves
from repro_torch.tree import tree_map as _map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" for the giant MoE cells
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moments (a tree like params)
    nu: Any              # second moments


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device (the reference's Python
    float, weakly typed, taken at float32)."""
    return torch.tensor(value, dtype=F32, device=like.device)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr``, in float32
    (the reference's int32 step over Python numbers is float32)."""
    s = step.to(F32)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), s),
                         _f32(1.0, s))
    prog = torch.clamp((s - _f32(cfg.warmup_steps, s))
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                       0.0, 1.0)
    cos = _f32(0.5, s) * (_f32(1.0, s) + torch.cos(_f32(math.pi, s) * prog))
    scale = (_f32(cfg.min_lr_ratio, s)
             + _f32(1 - cfg.min_lr_ratio, s) * cos)
    return _f32(cfg.lr, s) * warm * scale


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    leaves = [torch.sum(torch.square(x.to(F32))) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to a global norm of at most max_norm, norm)``: each
    leaf scaled in float32 and cast back to its own dtype."""
    norm = global_norm(tree)
    scale = torch.minimum(_f32(1.0, norm), _f32(max_norm, norm)
                          / torch.maximum(norm, _f32(1e-9, norm)))
    return _map(lambda g: (g.to(F32) * scale).to(g.dtype), tree), norm


def init(cfg: AdamWConfig, params) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)
    leaf = _leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      mu=_map(zeros, params), nu=_map(zeros, params))


def apply(cfg: AdamWConfig, params, grads, state: AdamWState
          ) -> tuple[Any, AdamWState, dict]:
    """One AdamW update.  Returns ``(params, state, metrics)``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    s = step.to(F32)
    bc1 = _f32(1.0, s) - torch.pow(_f32(cfg.b1, s), s)
    bc2 = _f32(1.0, s) - torch.pow(_f32(cfg.b2, s), s)
    b1, b2, c1, c2, eps = (_f32(v, s) for v in (
        cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps))

    def upd(p, g, m, v):
        g32 = g.to(F32)
        m32 = b1 * m.to(F32) + c1 * g32
        v32 = b2 * v.to(F32) + c2 * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if cfg.weight_decay and p.ndim >= 2:   # decay matrices only
            delta = delta + _f32(cfg.weight_decay, s) * p.to(F32)
        newp = (p.to(F32) - lr * delta).to(p.dtype)
        return newp, m32.to(m.dtype), v32.to(v.dtype)

    out = _map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: _map(lambda p, o: o[i], params, out)  # noqa: E731
    return pick(0), AdamWState(step, pick(1), pick(2)), {
        "grad_norm": gnorm, "lr": lr}
