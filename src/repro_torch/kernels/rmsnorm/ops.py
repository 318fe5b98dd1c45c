"""Public RMSNorm of the port (the reference's
``repro/kernels/rmsnorm/ops.py``): any leading shape."""

from __future__ import annotations

import torch

from .kernel import rmsnorm_fused


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x`` (..., d), contiguous; ``scale`` (d,) float32.  Returns
    ``rmsnorm(x) * (1 + scale)`` in ``x``'s dtype, through kernel D on
    the card and its plain version on the CPU."""
    d = x.shape[-1]
    return rmsnorm_fused(x.reshape(-1, d), scale, eps=eps).reshape(x.shape)
