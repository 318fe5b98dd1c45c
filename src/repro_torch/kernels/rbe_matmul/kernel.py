"""The RBE int8 matmul kernel for Hopper: build, binding and wrapper.

:func:`rbe_matmul_raw` replaces the reference's Pallas kernel
``repro/kernels/rbe_matmul/kernel.py::_rbe_matmul_kernel`` (through
``rbe_matmul_raw``): (M, K) int8 @ (K, N) int8 summed exactly in int32,
then ``f32(acc) * sx[m] * sw[n]``.  The kernel is CUDA C++
(``csrc/rbe_matmul.cu``, whose note gives its design and what bounds
it), built with ``nvcc`` for ``sm_90a`` at first use into ``build/`` and
loaded with ``ctypes``.  Given CPU tensors the wrapper runs the plain
version (:mod:`.ref`); given CUDA tensors it launches the kernel on the
current stream or raises.  It counts its launches in its ``launches``
attribute.

:func:`quantize_rowwise` is plain tensor code, as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .._build import BASE_FLAGS, Library
from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = Library("rbe_matmul", CSRC, "rbe_matmul.cu", ("rbe_matmul.cu",),
                  BASE_FLAGS)

#: Largest K whose int32 sums cannot overflow: 127² K < 2³¹.
MAX_K = (2**31 - 1) // (127 * 127)
#: Largest M the launch grid takes (65,535 blocks of 64 rows).
MAX_M = 65535 * 64


@functools.lru_cache(maxsize=1)
def _lib():
    lib = LIBRARY.load()
    lib.rbe_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rbe_matmul_launch.restype = ctypes.c_int
    lib.rbe_matmul_error_string.argtypes = [ctypes.c_int]
    lib.rbe_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name: str, dtype, device, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rbe_matmul_raw(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """Quantized matmul: (M, K) int8 @ (K, N) int8 -> (M, N) float32.

    ``sx`` (M,) per-row activation scales, ``sw`` (N,) per-channel weight
    scales, both float32 (the symmetric-quantization layout the RBE uses
    at 8 bit).  All four tensors contiguous and on one device.
    """
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(x_q.shape)} "
                         f"and {tuple(w_q.shape)}")
    (m, k), n = x_q.shape, w_q.shape[1]
    dev = x_q.device
    _check(x_q, "x_q", torch.int8, dev, (m, k))
    _check(w_q, "w_q", torch.int8, dev, (k, n))
    _check(sx, "sx", torch.float32, dev, (m,))
    _check(sw, "sw", torch.float32, dev, (n,))
    if k > MAX_K:
        raise ValueError(f"K = {k} exceeds {MAX_K}: the int32 sums could "
                         f"overflow")
    if dev.type == "cpu":
        return ref.rbe_matmul_ref(x_q, w_q, sx, sw)
    if dev.type != "cuda":
        raise ValueError(f"rbe_matmul_raw runs on cuda or cpu, not {dev}")
    if m > MAX_M:
        raise ValueError(f"M = {m} exceeds the launch grid's {MAX_M}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().rbe_matmul_launch(
            x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            out.data_ptr(), m, k, n,
            dev.index if dev.index is not None else 0, stream)
        if rc != 0:
            msg = _lib().rbe_matmul_error_string(rc).decode()
            raise RuntimeError(f"rbe_matmul_launch failed: {msg} "
                               f"(code {rc})")
        rbe_matmul_raw.launches += 1
    return out


rbe_matmul_raw.launches = 0


def quantize_rowwise(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization with per-row scales along ``axis``:
    returns ``(q, scale)``, ``q`` int8 in [-127, 127] (round half to
    even, as ``jnp.round``), ``scale`` float32 with ``axis`` removed."""
    amax = x.float().abs().amax(dim=axis, keepdim=True)
    # The reference writes jnp.maximum(amax, 1e-8) / 127.0, which XLA
    # lowers to a multiply by the float32 reciprocal of 127; torch
    # divides exactly on the CPU and by the reciprocal on CUDA, so the
    # multiply is written out to give the reference's scale on both.
    scale = amax.clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)
