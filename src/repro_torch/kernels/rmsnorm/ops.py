"""Public RMSNorm of the port (the reference's
``repro/kernels/rmsnorm/ops.py``): any leading shape, differentiable."""

from __future__ import annotations

import torch

from .._sharded import is_dtensor, local_call
from .kernel import rmsnorm_fused
from .ref import rmsnorm_bwd


class RMSNormFunction(torch.autograd.Function):
    """Kernel D under autograd: the forward is :func:`rmsnorm_fused`
    (kernel D on the card, its plain version on the CPU) on ``x`` (rows,
    d); the backward is :func:`.ref.rmsnorm_bwd`, torch ops in float32
    from the saved ``x`` and ``scale``, the same on every device."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fused(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def _sharded(x, scale, eps: float):
    """A DTensor ``x`` normed on its local (..., d) blocks: ``d`` whole
    (a sharded or partial mesh dim is made replicated first), the other
    dims as they are sharded; ``scale`` replicated, its gradient summed
    over the mesh dims that shard ``x``."""
    from torch.distributed.tensor import Partial, Replicate

    last = x.ndim - 1
    xp = tuple(Replicate() if p.is_partial()
               or (p.is_shard() and p.dim == last) else p
               for p in x.placements)
    rep = (Replicate(),) * len(xp)
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    return local_call(lambda xl, sl: rmsnorm(xl.contiguous(), sl, eps=eps),
                      (x, scale), (xp, rep), xp, (xp, grad))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x`` (..., d), contiguous; ``scale`` (d,) float32.  Returns
    ``rmsnorm(x) * (1 + scale)`` in ``x``'s dtype, through kernel D on
    the card, its plain version on the CPU and an empty result on
    ``meta`` (a launch a count credits); through
    :class:`RMSNormFunction` where autograd records (grad mode on and
    ``x`` or ``scale`` requiring grad), so the result has a
    ``grad_fn`` on every device.  A DTensor ``x`` runs the same on each
    local shard (:func:`_sharded`)."""
    if is_dtensor(x):
        return _sharded(x, scale, eps)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        y = RMSNormFunction.apply(x2, scale, eps)
    else:
        y = rmsnorm_fused(x2, scale, eps=eps)
    return y.reshape(x.shape)
