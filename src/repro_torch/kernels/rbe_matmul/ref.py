"""Plain PyTorch versions of the RBE int8 matmul (the reference's
``repro/kernels/rbe_matmul/ref.py``).

:func:`rbe_matmul_ref` is what the kernel of :mod:`.kernel` is held
against on the card, and what its wrapper runs for CPU tensors.  PyTorch
on CUDA has no integer ``matmul``, so the integer product is taken as a
float64 product of the int8 values: every partial sum is an integer of
magnitude at most 128² K, exact while that is below 2⁵³ (K below 2³⁹).
The sum is then reduced modulo 2³² into int32's range, as the
reference's int32 product wraps (XLA's integer arithmetic is two's
complement), so the two agree at any such K.
"""

from __future__ import annotations

import torch


def rbe_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """Exact integer accumulation, then dequant: ``(f32(acc) * sx[m]) *
    sw[n]``, in the reference's order."""
    acc = (x_q.double() @ w_q.double()).to(torch.int64)
    acc = (torch.remainder(acc + 2**31, 2**32) - 2**31).to(torch.int32)
    return acc.float() * sx[:, None] * sw[None, :]


def dequant_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float reference for end-to-end quantization error checks."""
    return x.float() @ w.float()
