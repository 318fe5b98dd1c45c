"""Gradient compression with error feedback (the reference's
``repro/optim/compression.py``): compress a gradient before it crosses
the expensive link, as the paper's ROI crosses MIPI instead of the raw
frame.

    c  = compress(grad + ef_buffer)                # bf16 / int8 + scale
    ef_buffer = (grad + ef_buffer) - decompress(c) # error feedback

Error feedback re-injects each step's quantization residual, so the sum
of what is sent tracks the sum of the true gradients.  This module holds
the compression math and the feedback state over trees (dicts, lists,
tuples, named tuples; ``None`` an empty subtree) of tensors; every value is float32 as in the reference.
``x / scale`` and ``amax / 127`` are true divisions on every device and
``torch.round`` rounds half to even as ``jnp.round`` does, so int8
payloads and scales equal the reference's bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"          # "none" | "bf16" | "int8"
    error_feedback: bool = True

    @property
    def bytes_per_element(self) -> float:
        return {"none": 4.0, "bf16": 2.0, "int8": 1.0}[self.kind]


class Compressed(NamedTuple):
    payload: Any     # quantized values
    scale: Any       # per-tensor float32 scale (int8 only; None otherwise)


def _is_compressed(x) -> bool:
    return isinstance(x, Compressed)


def _leaves(tree) -> list:
    """The leaves of a tree in the reference's order, a
    :class:`Compressed` one leaf."""
    return tree_leaves(tree, is_leaf=_is_compressed)


def compress_leaf(x: torch.Tensor, kind: str) -> Compressed:
    if kind == "none":
        return Compressed(x, None)
    if kind == "bf16":
        return Compressed(x.to(torch.bfloat16), None)
    if kind == "int8":
        amax = torch.max(torch.abs(x.to(F32)))
        # 127 as a tensor on x's device: on the card, a tensor divided by
        # a Python number is a multiply by its reciprocal, an ulp off the
        # true division the reference (and the CPU) takes
        scale = torch.clamp(amax, min=1e-12) / torch.full(
            (), 127.0, dtype=F32, device=x.device)
        q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127)
        return Compressed(q.to(torch.int8), scale)
    raise ValueError(kind)


def decompress_leaf(c: Compressed, dtype=F32) -> torch.Tensor:
    if c.scale is None:
        return c.payload.to(dtype)
    return (c.payload.to(F32) * c.scale).to(dtype)


def init_error_feedback(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads)


def compress_with_feedback(grads: Any, ef: Any,
                           cfg: CompressionConfig) -> tuple[Any, Any]:
    """Returns (compressed tree, new error-feedback tree).

    The compressed tree holds :class:`Compressed` leaves; transmit those,
    then :func:`decompress_tree` on the receiving side.
    """
    if cfg.kind == "none":
        return tree_map(lambda g: Compressed(g, None), grads), ef
    new_ef = []

    def one(g, e):
        target = g.to(F32) + e if cfg.error_feedback else g.to(F32)
        c = compress_leaf(target, cfg.kind)
        recon = decompress_leaf(c)
        new_ef.append(target - recon if cfg.error_feedback
                      else torch.zeros_like(target))
        return c

    comp = tree_map(one, grads, ef)
    it = iter(new_ef)   # tree_map visits the leaves in the same order
    return comp, tree_map(lambda _: next(it), grads)


def decompress_tree(comp: Any, dtype=F32) -> Any:
    return tree_map(lambda c: decompress_leaf(c, dtype), comp,
                    is_leaf=_is_compressed)


def compressed_bytes(grads: Any, cfg: CompressionConfig) -> float:
    """Bytes on the wire for one compressed gradient exchange."""
    return sum(g.numel() * cfg.bytes_per_element for g in _leaves(grads))
