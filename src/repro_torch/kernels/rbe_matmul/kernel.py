"""Kernel C, the RBE int8 matmul for Hopper: build, binding, plan and
wrapper.

:func:`rbe_matmul_raw` replaces the reference's Pallas kernel
``repro/kernels/rbe_matmul/kernel.py::_rbe_matmul_kernel`` (through
``rbe_matmul_raw``): (M, K) int8 @ (K, N) int8 summed exactly in int32,
then ``f32(acc) * sx[m] * sw[n]``.  The kernel is CUDA C++
(``csrc/rbe_matmul.cu``, whose note gives its design), built with
``nvcc`` for ``sm_90a`` at first use into ``build/`` and loaded with
``ctypes``.  At the pipeline's shapes its bound is bytes, far below a
launch, so its time is latency: it runs the products on the int8 tensor
cores (``mma.sync`` m16n8k32, exact int32 sums), brings a block's whole
K (up to :data:`KC_MAX` bytes) into shared memory with one round of
16-byte ``cp.async`` copies, transposes w's 4 x 4 byte blocks into the
``col`` B fragment with ``__byte_perm``, and takes 32 x 32 tiles while
64 x 64 ones would not fill the card.  :func:`plan` picks the tile, the
stage depth and the shared memory in plain Python.  Given CPU tensors
the wrapper runs the plain version (:mod:`.ref`); given CUDA tensors it
launches the kernel on the current stream or raises.  It counts its
launches in its ``launches`` attribute.  ptxas's registers for both
tiles are in PERF.md (``chip_smoke.py`` reports them).

:func:`quantize_rowwise` is plain tensor code, as in the reference.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from .._build import BASE_FLAGS, Library
from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = Library("rbe_matmul", CSRC, "rbe_matmul.cu", ("rbe_matmul.cu",),
                  BASE_FLAGS)

#: Largest K whose int32 sums cannot leave int32 on the card: int8
#: reaches -128, so |sum| <= 128² K <= 2³¹ - 1.  Larger K is refused on
#: CUDA tensors (whether the tensor cores' s32 sums wrap as int32 does is
#: not relied on); CPU tensors take the plain version, which wraps.
MAX_K = (2**31 - 1) // (128 * 128)
#: Largest M the launcher's int32 takes (M tiles run on the grid's x,
#: which holds 2³¹ - 1 blocks; N tiles on its y, which :func:`plan`
#: checks).
MAX_M = 2**31 - 1

#: Block tiles: (rows, columns, threads, launcher code).  Each warp takes
#: 16 or 32 rows by 32 columns.
TILES = {"small": (32, 32, 64, 0), "large": (64, 64, 128, 1)}
#: Bytes of K a shared-memory stage holds at most, and the ring's depth
#: when K takes more than one stage.
KC_MAX, STAGES = 256, 2
#: SMs of an H100 SXM: the large tile needs a grid this big to fill them.
SMS = 132
#: Shared memory a block may take on an H100.
SMEM_PER_BLOCK = 232_448


@dataclasses.dataclass(frozen=True)
class Plan:
    """How kernel C runs one (m, k, n) product: ``tile`` (``"small"``,
    32 x 32, or ``"large"``, 64 x 64) of ``bm`` x ``bn`` outputs and
    ``threads`` threads a block, ``grid`` (m tiles, n tiles), ``kc``
    bytes of K a stage, ``stages`` stages in shared memory (1: all of K
    in one copy), ``smem_bytes`` of dynamic shared memory: a stage is
    ``bm`` rows of ``kc + 16`` bytes of x and ``kc`` rows of ``bn`` bytes
    of w."""

    tile: str
    bm: int
    bn: int
    threads: int
    grid: tuple
    kc: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int) -> Plan:
    """Kernel C's launch for an (m, k, n) product: the large tile where
    its grid fills the card's SMs, else the small one (more blocks); K in
    stages of up to :data:`KC_MAX` bytes, a multiple of 32 (one mma
    depth), one stage where K fits it, else a ring of :data:`STAGES`."""
    if m < 1 or n < 1 or k < 0:
        raise ValueError(f"no plan for an empty product ({m}, {k}, {n})")
    bm, bn, threads, _ = TILES["large"]
    tile = "large" if -(-m // bm) * -(-n // bn) >= SMS else "small"
    bm, bn, threads, _ = TILES[tile]
    grid = (-(-m // bm), -(-n // bn))
    if grid[1] > 65535:
        raise ValueError(f"N = {n} exceeds the launch grid's 65,535 "
                         f"column tiles")
    kc = min(max(32, -(-k // 32) * 32), KC_MAX)
    stages = STAGES if k > kc else 1
    smem = stages * (bm * (kc + 16) + kc * bn)
    return Plan(tile, bm, bn, threads, grid, kc, stages, smem)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = LIBRARY.load()
    lib.rbe_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
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


def check_k(k: int) -> None:
    """Refuse a K whose int32 sums could overflow on the card."""
    if k > MAX_K:
        raise ValueError(f"K = {k} exceeds {MAX_K}: the int32 sums could "
                         f"overflow")


def rbe_matmul_raw(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """Quantized matmul: (M, K) int8 @ (K, N) int8 -> (M, N) float32.

    ``sx`` (M,) per-row activation scales, ``sw`` (N,) per-channel weight
    scales, both float32 (the symmetric-quantization layout the RBE uses
    at 8 bit).  All four tensors contiguous and on one device.  On the
    CPU any K runs, and sums beyond int32 wrap as the reference's do; on
    the card K is at most :data:`MAX_K`.
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
    if dev.type == "cpu":
        return ref.rbe_matmul_ref(x_q, w_q, sx, sw)
    if dev.type != "cuda":
        raise ValueError(f"rbe_matmul_raw runs on cuda or cpu, not {dev}")
    check_k(k)
    if m > MAX_M:
        raise ValueError(f"M = {m} exceeds the launcher's {MAX_M}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        p = plan(m, k, n)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().rbe_matmul_launch(
            x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            out.data_ptr(), m, k, n, TILES[p.tile][3], p.kc, p.smem_bytes,
            *p.grid, dev.index if dev.index is not None else 0, stream)
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
