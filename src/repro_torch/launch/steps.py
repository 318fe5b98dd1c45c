"""Step functions: train_step, prefill_step, serve_step (the reference's
``repro/launch/steps.py``).

The reference returns jittable pure functions; the port's run eagerly.
A train step takes the gradient of :func:`repro_torch.models.
transformer.loss_fn` with ``torch.autograd.grad`` over the parameter
leaves (no graph outlives the call) and applies the port's AdamW
(:mod:`repro_torch.optim.adamw`), whose update returns new tensors: the
new parameters are made leaves that require grad for the next step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def trainable(params):
    """``params`` with every leaf a detached tensor that requires grad."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def value_and_grad(cfg: ModelConfig, params, batch: T.Batch,
                   remat: bool = False) -> tuple[torch.Tensor, Any]:
    """``(loss, grads)``: the loss (detached) and its gradient with
    respect to every leaf of ``params`` (which must require grad), in
    ``params``' structure and dtypes.  A leaf the loss does not read
    (the embedding table of a model fed ``Batch.embeds`` with an untied
    head) gets zeros, as ``jax.grad`` gives it."""
    leaves: list = []
    tree_map(leaves.append, params)
    loss = T.loss_fn(cfg, params, batch, remat=remat)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, params)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    remat: bool = True):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch: T.Batch):
        loss, grads = value_and_grad(cfg, params, batch, remat)
        with torch.no_grad():
            params, opt_state, metrics = adamw.apply(opt_cfg, params, grads,
                                                     opt_state)
        metrics["loss"] = loss
        return trainable(params), opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits (B, 1, V).

    Serving prefill: run the full-sequence stack; only the final
    position's logits are needed to emit the first token.
    """

    def prefill_step(params, batch: T.Batch):
        with torch.no_grad():
            h, _ = T.hidden_states(cfg, params, batch)
            return T._logits(cfg, params, h[:, -1:])

    return prefill_step


def make_serve_step(cfg: ModelConfig, mla_absorb: bool = False):
    """(params, cache, batch, pos) -> (logits (B,1,V), cache)."""

    def serve_step(params, cache, batch: T.Batch, pos):
        with torch.no_grad():
            return T.decode_step(cfg, params, cache, batch, pos,
                                 mla_absorb=mla_absorb)

    return serve_step
