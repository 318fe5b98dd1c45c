"""Plain PyTorch RMSNorm (the reference's ``repro/kernels/rmsnorm/ref.py``)
and its gradient.

:func:`rmsnorm_ref` is what kernel D (:mod:`.kernel`) is held against on
the card, and what its wrapper runs for CPU tensors.
:func:`rmsnorm_bwd` is the backward of :class:`.ops.RMSNormFunction` on
every device: the reference differentiates its jnp RMSNorm, and has no
Pallas backward.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * (1 + scale)`` over the last axis,
    in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of :func:`rmsnorm_ref` at ``x`` (rows, d) and ``scale``
    (d,) for the output cotangent ``g`` (rows, d), in float32 from the
    saved inputs: with ``r = rsqrt(mean(x²) + eps)``, ``y = x·r`` and
    ``gy = g·(1 + scale)``, ``dx = r·(gy − y·mean(gy·y))`` and ``dscale
    = Σ_rows g·y``, cast to ``x``'s and ``scale``'s dtypes."""
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    y = x32 * r
    gy = g32 * (1.0 + scale.float())
    dx = r * (gy - y * (gy * y).mean(dim=-1, keepdim=True))
    dscale = (g32 * y).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
