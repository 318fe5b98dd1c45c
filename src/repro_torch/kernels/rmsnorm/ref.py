"""Plain PyTorch RMSNorm (the reference's ``repro/kernels/rmsnorm/ref.py``).

:func:`rmsnorm_ref` is what kernel D (:mod:`.kernel`) is held against on
the card, and what its wrapper runs for CPU tensors.
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
