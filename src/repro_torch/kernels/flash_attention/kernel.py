"""Kernel E, flash-attention forward for Hopper: build, binding, plan and
wrapper.

:func:`flash_attention_fwd` replaces the reference's Pallas kernel
``repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel`` (through
``flash_attention_fwd``): GQA attention with a causal mask at absolute
positions, an optional sliding window and an optional tanh logit
softcap, online softmax with float32 statistics.  The head dim of q and
k may differ from v's (MLA: q·k over 192, v 128), as the reference's
``models/flash.py`` allows; the output takes v's.  The kernels are CUDA
C++ (``csrc/flash_attention.cu``, whose note gives their design and what
bounds them), built with ``nvcc`` for ``sm_90a`` at first use into
``build/`` and loaded with ``ctypes``: bf16 inputs take the tensor-core
route (``mma.sync``, p@v exact through a three-piece bf16 split of p),
float32 inputs the CUDA-core route.  :func:`plan` chooses the route and
its tiling in plain Python.  Given CPU tensors the wrapper runs the
plain version (:func:`.ref.flash_attention_ref`); given CUDA tensors it
launches the kernel on the current stream or raises.  It counts its
launches in its ``launches`` attribute, and reports each to
:mod:`.._credit`: while a program is counted, a launch does the work of
the reference's blockwise plain version
(:func:`repro_torch.models.flash.blockwise_fwd`) over the static pairs
of the ``blocks`` it is given.  With ``return_stats=True`` it
also returns each row's softmax statistics (running max ``m`` and sum
``l``, float32, (B, Sq, KV, g)), the residuals of the flash backward
(:class:`repro_torch.models.flash.FlashAttentionFunction`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from .. import _credit
from .._build import BASE_FLAGS, Library
from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# BASE_FLAGS alone: held to a tolerance, not bitwise, so FMA contraction
# stays on (the f32 route's dot products are explicit fmaf chains, the
# bf16 route's are mma instructions); no --use_fast_math, so expf and
# tanhf keep their full-accuracy forms (__expf is a 2-ulp approximation
# that loses range near the masked scores).
LIBRARY = Library("flash_attention", CSRC, "flash_attention.cu",
                  ("flash_attention.cu",), BASE_FLAGS)

#: dtype codes of the C interface, and the (q·k, v) head-dim pairs it is
#: built for: equal dims (GQA), and MLA's (192, 128) for deepseek-v2 and
#: (48, 32) for its reduced config.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
             (48, 32))
#: route codes of the C interface.
ROUTES = {"simt": 0, "mma": 1}

#: An H100 SM's shared memory, the most one block may take, and what the
#: runtime keeps for each resident block (bytes).
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1_024
#: Rows of the folded (Sq x g) query matrix a block owns, on both routes.
ROWS = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How kernel E runs one call.  ``route``: ``"mma"`` (bf16 inputs:
    tensor cores, 4 warps of 16 rows, a ``cp.async`` ring of ``stages``
    K/V tiles) or ``"simt"`` (float32 inputs: CUDA cores, 8 warps, one
    tile staged as float32).  ``rows``: rows of the folded query matrix
    a block; ``keys``: keys a K/V tile; ``smem_bytes``: dynamic shared
    memory a block; ``grid``: (q tiles, kv heads, batch)."""

    route: str
    rows: int
    keys: int
    stages: int
    smem_bytes: int
    grid: tuple

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory alone."""
        return SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED)


def plan(b: int, sq: int, h: int, kvh: int, d: int, dtype: torch.dtype,
         dv: int | None = None) -> Plan:
    """The route and tiling of kernel E for q (b, sq, h, d) on kvh kv
    heads, v's head dim ``dv`` (``d`` by default).  bf16 takes the tensor
    cores: 64-key tiles (32 at d 256, where the f32 O accumulator takes
    half the registers), q and K rows of d and V rows of dv each padded
    by 16 bytes, and as many stages (2 or 3) as leave room for two blocks
    an SM.  float32 keeps the CUDA-core kernel's tiling (q and K of d, V
    of dv, staged as float32)."""
    dv = d if dv is None else dv
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype}: expected float32 or bfloat16")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q·k, v) = ({d}, {dv}): the kernel is "
                         f"built for {HEAD_DIMS}")
    grid = (-(-sq * (h // kvh) // ROWS), kvh, b)
    if dtype == torch.float32:
        smem = 4 * (ROWS * d + 32 * (d + 4) + 32 * dv)
        return Plan("simt", ROWS, 32, 1, smem, grid)
    keys = 32 if d == 256 else 64
    qk_row, v_row = 2 * (d + 8), 2 * (dv + 8)
    q_bytes, stage_bytes = ROWS * qk_row, keys * (qk_row + v_row)
    room = SMEM_PER_SM // 2 - SMEM_RESERVED - q_bytes
    stages = max(2, min(3, room // stage_bytes))
    return Plan("mma", ROWS, keys, stages, q_bytes + stages * stage_bytes,
                grid)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = LIBRARY.load()
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype}: expected float32 or bfloat16")
    b, sq, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Skv, KV, D) and (B, Skv, KV, Dv) with q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads are not a multiple of "
                         f"{k.shape[2]} kv heads")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0,
                        scale: float | None = None,
                        return_stats: bool = False,
                        blocks: tuple[int, int] = (512, 512)):
    """q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv), one
    dtype (float32 or bfloat16), contiguous, on one device.  Returns (B,
    Sq, H, Dv) in q's dtype, and with ``return_stats`` ``(out, m, l)``,
    the float32 softmax statistics of each row, (B, Sq, KV, g).
    ``window`` 0 and ``logit_softcap`` 0 turn those off.  The scale
    defaults to D^-0.5.  ``blocks``, the (q, kv) blocks of the caller's
    blockwise algorithm (the reference model's 512, clipped to the
    sequences), change nothing but what a count credits (the kernel
    picks its own tiles, :func:`plan`)."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    dv = v.shape[3]
    skv, kvh = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       logit_softcap=logit_softcap,
                                       scale=scale, return_stats=return_stats)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not "
                         f"{dev}")
    p = plan(b, sq, h, kvh, d, q.dtype, dv)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    m = l = None
    if return_stats:
        m = torch.empty((b, sq, kvh, h // kvh), dtype=torch.float32,
                        device=dev)
        l = torch.empty_like(m)
    if b and sq and skv and h:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr() if return_stats else None,
            l.data_ptr() if return_stats else None,
            b, sq, skv, h, kvh, d, dv, int(bool(causal)), int(window),
            float(logit_softcap), scale, DTYPES[q.dtype], ROUTES[p.route],
            p.keys, p.stages, p.smem_bytes, p.grid[0],
            dev.index if dev.index is not None else 0, stream)
        if rc != 0:
            msg = _lib().flash_attention_error_string(rc).decode()
            raise RuntimeError(f"flash_attention_launch failed: {msg} "
                               f"(code {rc})")
        flash_attention_fwd.launches += 1
        if _credit.active():
            from repro_torch.models.flash import blockwise_fwd

            _credit.credit(
                "flash_attention", blockwise_fwd, (q, k, v),
                dict(causal=causal, window=window,
                     logit_softcap=logit_softcap, scale=scale,
                     return_stats=return_stats, blocks=tuple(blocks)),
                (q, k, v), (out, m, l))
    return (out, m, l) if return_stats else out


flash_attention_fwd.launches = 0
