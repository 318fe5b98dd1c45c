"""Kernel D, RMSNorm for Hopper: build, binding, plan and wrapper.

:func:`rmsnorm_fused` replaces the reference's Pallas kernel
``repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel`` (through
``rmsnorm_fused``): each row of a (rows, d) float32 or bfloat16 tensor
becomes ``x * rsqrt(mean(x²) + eps) * (1 + scale)`` in float32 math,
written in the input's dtype.  The kernel is CUDA C++
(``csrc/rmsnorm.cu``, whose note gives its design and what bounds it),
built with ``nvcc`` for ``sm_90a`` at first use into ``build/`` and
loaded with ``ctypes``.  :func:`plan` picks its route in plain Python: a
warp a row with the row held in 16-byte vectors, or the strided
fallback where ``d`` or a pointer breaks 16-byte alignment.  Given CPU
tensors the wrapper runs the plain version (:func:`.ref.rmsnorm_ref`);
given CUDA tensors it launches the kernel on the current stream or
raises; given ``meta`` tensors it returns an empty result (a count of
the program still credits the launch); a DTensor it refuses.  It counts
its launches in its ``launches`` attribute, and reports each to :mod:`.._credit` (while a program is counted, its work
is the plain version's at the same shapes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from .. import _credit
from .._build import BASE_FLAGS, Library
from .._sharded import refuse
from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# BASE_FLAGS alone: the kernel is held to a tolerance, not bitwise, so
# FMA contraction stays on (--fmad=false is for the sweep grid's bitwise
# contract), and no --use_fast_math, so rsqrtf and the division by d keep
# their full-accuracy forms.
LIBRARY = Library("rmsnorm", CSRC, "rmsnorm.cu", ("rmsnorm.cu",), BASE_FLAGS)

#: dtype codes of the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: route codes of the C interface.
ROUTES = {"strided": 0, "vector": 1}
#: Warps a block; 16-byte vectors a lane at most (the row is held in
#: registers); warps a row when one warp's lanes cannot hold it, or when
#: there are fewer than FEW_ROWS rows (decode: a call's time is then its
#: latency, which a row spread over a block's 8 warps cuts).
WARPS = 8
MAX_VECTORS = 16
WIDE_WARPS = 8
FEW_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """How kernel D runs one call.  ``route``: ``"vector"`` (a lane holds
    ``vectors`` 16-byte vectors of its row, ``warps_per_row`` warps a
    row, 8 warps a block) or ``"strided"`` (a 256-thread block a row,
    scalar loads); ``grid``: blocks."""

    route: str
    vectors: int
    warps_per_row: int
    rows_per_block: int
    grid: int


def plan(rows: int, d: int, itemsize: int, *pointers: int) -> Plan:
    """The route of kernel D for ``rows`` rows of ``d`` elements of
    ``itemsize`` bytes at the given data pointers (x, scale, out): the
    vector route where ``d`` fills whole 16-byte vectors and every
    pointer is 16-byte aligned, with one warp a row while 16 vectors a
    lane hold it (d <= 4096 bf16, 2048 f32) and there are FEW_ROWS rows
    or more, else 8; the strided route otherwise."""
    per_vec = 16 // itemsize
    if d % per_vec == 0 and all(p % 16 == 0 for p in pointers):
        nv = d // per_vec
        for w in ((1, WIDE_WARPS) if rows >= FEW_ROWS else (WIDE_WARPS,)):
            v = -(-nv // (32 * w))
            if v <= MAX_VECTORS:
                rpb = WARPS // w
                return Plan("vector", v, w, rpb, -(-rows // rpb))
    return Plan("strided", 0, WARPS, 1, rows)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = LIBRARY.load()
    lib.rmsnorm_launch.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p])
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_fused(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (rows, d), float32 or bfloat16,
    contiguous; ``scale`` (d,) float32 on the same device.  Returns a
    new tensor of ``x``'s shape and dtype."""
    if not isinstance(x, torch.Tensor) or not isinstance(scale,
                                                         torch.Tensor):
        raise TypeError("x and scale must be torch.Tensors")
    refuse("rmsnorm_fused", x, scale)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or "
                        f"bfloat16")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be float32 of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    dev = x.device
    if dev.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm_fused runs on cuda, cpu or meta, not "
                         f"{dev}")
    out = torch.empty_like(x)
    if dev.type == "meta":
        # shapes only: no launch, but a count credits the kernel's work
        if _credit.active():
            _credit.credit("rmsnorm", ref.rmsnorm_ref, (x, scale, eps), {},
                           (x, scale), (out,))
        return out
    if rows and d:
        p = plan(rows, d, x.element_size(), x.data_ptr(), scale.data_ptr(),
                 out.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
            float(eps), DTYPES[x.dtype], ROUTES[p.route], p.vectors,
            p.warps_per_row, p.grid,
            dev.index if dev.index is not None else 0, stream)
        if rc != 0:
            msg = _lib().rmsnorm_error_string(rc).decode()
            raise RuntimeError(f"rmsnorm_launch failed: {msg} (code {rc})")
        rmsnorm_fused.launches += 1
        if _credit.active():
            _credit.credit("rmsnorm", ref.rmsnorm_ref, (x, scale, eps), {},
                           (x, scale), (out,))
    return out


rmsnorm_fused.launches = 0
