"""Float-in/float-out int8 matmul on the RBE path (the reference's
``repro/kernels/rbe_matmul/ops.py``)."""

from __future__ import annotations

import torch

from .kernel import quantize_rowwise, rbe_matmul_raw


def rbe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` per row and ``w`` per column to int8 and multiply
    on the 8-bit path: (M, K) float @ (K, N) float -> (M, N) float32."""
    x_q, sx = quantize_rowwise(x, axis=-1)
    w_q, sw = quantize_rowwise(w, axis=0)
    return rbe_matmul_raw(x_q.contiguous(), w_q.contiguous(),
                          sx.contiguous(), sw.contiguous())
