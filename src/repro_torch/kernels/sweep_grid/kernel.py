"""Hand-written Hopper kernels of the sweep grid: build, binding, plan,
wrappers.

Two CUDA C++ kernels in ``csrc/`` (see the note at the top of
``csrc/sweep_grid.cu`` for their design and what bounds them):

* :func:`sweep_grid_chunk` — kernel A, replacing the reference's fused
  Pallas chunk kernel ``repro/kernels/sweep_grid/kernel.py::
  build_chunk_call``: decode + Eq. 1-11 + constraint mask + dominance
  pre-filter + per-block reductions, returning the partials of
  :func:`repro_torch.core.backend.chunk_partials` key for key.  Its
  time is latency: each lane is a chain of dependent table gathers and
  IEEE divide sequences, far from the float64 pipe's rate.  So a block
  of :data:`CHUNK_LANES`-lane threads serves one 512-lane partial block
  and :data:`CHUNK_MIN_BLOCKS` such blocks fit an SM (a register cap
  through ``__launch_bounds__``), every tracked channel is reduced in one
  pass of warp shuffles, and the dominance filter stops at the first of
  its rows that dominates a lane (its rows and edges in shared memory).
  :func:`chunk_plan` gives the launch in plain Python.
* :func:`sweep_grid_eval` — kernel B, replacing ``_flat_call`` /
  ``sweep_grid_eval`` there: decode + Eq. 1-11 at explicit flat
  indices.  At the dense engine's size its bytes bound it, at the
  stream probe's a launch and one lane's chain; its time is the integer
  work around Eq. 1-11.  It decodes by a multiply-high by host-computed
  multipliers (:func:`div_magic`) in 32-bit integers below 2³¹
  configurations and keeps every channel in registers.
  :func:`eval_plan` gives its launch: small blocks that spread over the
  SMs for few indices; at the dense size :data:`EVAL_CONFIGS`
  consecutive indices a thread, which share their decode and every
  table gather off the grid's last axis, with the tables staged in
  shared memory.

Both call one ``__device__`` function, ``eval_config``, so their values
agree to the bit, and both are compiled with ``--fmad=false`` and IEEE
division so they compute what the plain PyTorch version
(:mod:`.ref`) computes, operation for operation.

A third kernel, F (:func:`sweep_grid_fold`, ``csrc/fold.cuh``), folds
kernel A's partials into the chunk step's carry in place and compacts
the chunk's survivors: what :func:`repro_torch.core.backend.fold_chunk`
computes with torch ops, bit for bit, in one launch a chunk (a block
for each of its independent parts).  It replaces no Pallas kernel (the
reference folds with jnp ops).  :func:`fold_plan` gives its launch;
:data:`FOLD_MAX_K` and :data:`FOLD_MAX_BINS` bound the specs it serves
(:func:`fold_runs`).

The library is built with ``nvcc`` for ``sm_90a`` from the sources in
the checkout at first use (never at import), into ``build/`` at the
root of the checkout, and loaded with ``ctypes``.  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its
kernel on the current stream or raises.  Each wrapper counts its
launches in its ``launches`` attribute.  ptxas's registers for both
kernels are in PERF.md (``chip_smoke.py`` reports them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import numpy as np
import torch

from repro_torch.core import arrays as A
from repro_torch.core import sweep as SW

from .._build import BASE_FLAGS, Library
from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: Kernel A: lanes a thread (a block of 512 / CHUNK_LANES threads serves
#: one 512-lane partial block) and the blocks an SM its register cap
#: (``__launch_bounds__(512 / CHUNK_LANES, CHUNK_MIN_BLOCKS)``) makes room
#: for.  The build takes both from here.
CHUNK_LANES = 2
CHUNK_MIN_BLOCKS = 2
#: Kernel B: threads a block at most, consecutive indices a thread on
#: its dense plan, and the blocks an SM its register cap
#: (``__launch_bounds__(EVAL_THREADS, EVAL_MIN_BLOCKS)``) makes room for.
#: The build takes all three from here.
EVAL_THREADS = 128
EVAL_CONFIGS = 2
EVAL_MIN_BLOCKS = 3
#: SMs of an H100 SXM: below this many blocks kernel B's plan shrinks
#: its blocks so that the work spreads over them.
SMS = 132
#: An H100 SM: 32-bit registers, threads, shared memory (bytes) a block
#: may take, an SM holds and the system keeps a block, and the registers
#: a thread at most.
SM_REGISTERS, SM_THREADS = 65536, 2048
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1024
MAX_REGISTERS = 255

#: Kernel F: threads of each of its blocks.  The build takes it from
#: here.
FOLD_THREADS = 512
#: The largest top-k table and histogram kernel F serves (``FOLD_MAX_K``
#: and ``FOLD_MAX_BINS`` in ``csrc/fold.cuh``): a spec above either keeps
#: ``fold_chunk``'s torch ops.
FOLD_MAX_K = 64
FOLD_MAX_BINS = 16384
#: Kernel F's static shared memory: the selected blocks, and the warps'
#: survivor counts and block-min partials.
FOLD_STATIC_SMEM = 4 * FOLD_MAX_K + (4 + 8) * (FOLD_THREADS // 32)

#: The kernels' library.  ``--fmad=false`` keeps every float64 add and
#: multiply a separate IEEE operation, as in the plain version.
LIBRARY = Library("sweep_grid", CSRC, "sweep_grid.cu",
                  ("sweep_grid.cu", "sweep_grid.cuh", "fold.cuh"),
                  BASE_FLAGS + ("--fmad=false",
                                f"-DCHUNK_LANES={CHUNK_LANES}",
                                f"-DCHUNK_MIN_BLOCKS={CHUNK_MIN_BLOCKS}",
                                f"-DEVAL_THREADS={EVAL_THREADS}",
                                f"-DEVAL_CONFIGS={EVAL_CONFIGS}",
                                f"-DEVAL_MIN_BLOCKS={EVAL_MIN_BLOCKS}",
                                f"-DFOLD_THREADS={FOLD_THREADS}"))

#: Tables the kernels read, in the order of ``enum Table`` in
#: ``csrc/sweep_grid.cuh``.
_WL = ("c_macs", "c_weight_bytes", "c_weight_stream", "c_act_traffic",
       "c_cycles_sensor", "c_cycles_agg", "peak_prefix", "peak_suffix")
KERNEL_TABLES = (("det.n_layers", "key.n_layers", "det.input_bytes")
                 + tuple("det." + n for n in _WL)
                 + tuple("key." + n for n in _WL)
                 + ("e_mac", "f_clk", "sram_e_read", "sram_e_write",
                    "sram_leak_on", "sram_leak_ret", "wm_e_read",
                    "wm_leak_on", "wm_leak_ret", "pay_cam_rate",
                    "pay_det_rate", "pay_key_rate", "pay_max"))

#: ``struct Consts`` of ``csrc/sweep_grid.cuh``, in order.
_CONSTS = (A.CAMERA_SENSE_W, A.CAMERA_READ_W, A.CAMERA_IDLE_W, A.T_SENSE,
           A.MIPI_E_PER_BYTE, A.MIPI_BW, A.UTSV_E_PER_BYTE, A.UTSV_BW,
           A.FULL_FRAME, A.L1_ENERGY_SCALE, float(A.SENSOR_L1_BYTES),
           float(A.AGG_L1_BYTES))

_OPS = {"<=": 0, ">=": 1, "<": 2, ">": 3}
MAX_CONS = 8
MAX_ROWS = 64
MAX_W = 512


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """How kernel A runs one chunk: ``blocks`` blocks (one a 512-lane
    partial block, ``spec.n_blocks``) of ``threads`` threads, ``lanes``
    lanes a thread (lane ``t + j * threads`` of the block for ``j <
    lanes``), ``smem_bytes`` of dynamic shared memory; ``registers`` is
    the most a thread may use under the launch bounds, and
    ``blocks_per_sm`` the blocks an SM then holds."""

    threads: int
    lanes: int
    blocks: int
    smem_bytes: int
    registers: int
    blocks_per_sm: int


def chunk_smem_bytes(n_rows: int, d: int, edge_len: int, nf: int, W: int,
                     warps: int) -> int:
    """Kernel A's shared memory (``chunk_smem_bytes`` in the .cu): the
    filter rows and edges, each tracked channel's lane values, and the
    warps' partials (value, max, index: 8 bytes; count: 4) of the nf + d
    reductions."""
    parts = (nf + d) * warps
    return 8 * (n_rows * d + edge_len + nf * W + 3 * parts) + 4 * parts


def chunk_plan(spec) -> ChunkPlan:
    """Kernel A's launch for ``spec``: :data:`CHUNK_LANES` lanes a
    thread, as many whole warps as cover ``spec.block`` lanes, and room
    for the prefix-min table's edges wherever it may apply (2 <= d <=
    3)."""
    return _chunk_plan(spec.block, spec.d, len(spec.fields),
                       spec.filter_rows, spec.filter_bins, spec.n_blocks)


@functools.lru_cache(maxsize=256)
def _chunk_plan(W: int, d: int, nf: int, rows: int, bins: int,
                blocks: int) -> ChunkPlan:
    per_lane = -(-W // CHUNK_LANES)
    threads = -(-per_lane // 32) * 32
    edge_len = (d - 1) * (bins + 1) if 2 <= d <= 3 else 0
    smem = chunk_smem_bytes(rows, d, edge_len, nf, W, threads // 32)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"kernel A needs {smem} bytes of shared memory, "
                         f"more than a block's {SMEM_PER_BLOCK}")
    registers = min(MAX_REGISTERS, SM_REGISTERS // (
        MAX_W // CHUNK_LANES * CHUNK_MIN_BLOCKS) // 8 * 8)
    # registers are allocated a warp at a time, in units of 256
    per_warp = -(-registers * 32 // 256) * 256
    blocks_per_sm = min(SM_REGISTERS // (per_warp * (threads // 32)),
                        SM_THREADS // threads,
                        SMEM_PER_SM // (smem + SMEM_RESERVED))
    return ChunkPlan(threads, CHUNK_LANES, blocks, smem, registers,
                     blocks_per_sm)


@dataclasses.dataclass(frozen=True)
class FoldPlan:
    """How kernel F folds one chunk: ``blocks`` blocks of ``threads``
    threads, a part of the fold each (the top-k of each objective, the
    argmin, the survivors, and each objective's histogram where there are
    bins); in a top-k selection each warp keeps a sorted list of ``32 *
    lists`` (value, index) pairs in registers (``lists`` a lane: 1 for k
    <= 32, else 2); ``smem_bytes`` of dynamic shared memory (a list a
    warp, or a histogram's counters where they take more)."""

    threads: int
    blocks: int
    lists: int
    smem_bytes: int


def fold_lists(k: int) -> int:
    """Pairs a lane holds in kernel F's selections (``fold_lists`` in
    ``csrc/fold.cuh``): 1 for k <= 32, else 2."""
    return 1 if k <= 32 else 2


def fold_smem_bytes(k: int, bins: int) -> int:
    """Kernel F's dynamic shared memory (``fold_smem_bytes`` in
    ``csrc/fold.cuh``): a list of ``32 * fold_lists(k)`` (value, index)
    pairs for each of its warps, or 4 bytes a histogram bin where that
    is more."""
    return max(16 * (FOLD_THREADS // 32) * 32 * fold_lists(k), 4 * bins)


def fold_runs(spec) -> bool:
    """Whether kernel F folds ``spec``'s chunks: a top-k of at most
    :data:`FOLD_MAX_K` and at most :data:`FOLD_MAX_BINS` histogram bins."""
    return spec.k <= FOLD_MAX_K and spec.hist_bins <= FOLD_MAX_BINS


def fold_plan(spec) -> FoldPlan:
    """Kernel F's launch for ``spec``: a block of :data:`FOLD_THREADS`
    threads for each part of the fold, the pairs a lane its selections
    need for ``spec.k``, and their shared memory."""
    return _fold_plan(spec.d, spec.k, spec.hist_bins)


@functools.lru_cache(maxsize=256)
def _fold_plan(d: int, k: int, bins: int) -> FoldPlan:
    if not (1 <= k <= FOLD_MAX_K and 0 <= bins <= FOLD_MAX_BINS):
        raise ValueError(f"kernel F folds a top-k of 1 to {FOLD_MAX_K} and "
                         f"at most {FOLD_MAX_BINS} histogram bins, not k = "
                         f"{k} and {bins} bins")
    return FoldPlan(FOLD_THREADS, d + 2 + (d if bins else 0),
                    fold_lists(k), fold_smem_bytes(k, bins))


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """How kernel B runs ``n`` flat indices: ``blocks`` blocks of
    ``threads`` threads, ``configs`` consecutive indices a thread (index
    ``(block * threads + thread) * configs + j``), decoded in
    ``index_bits``-bit integers; ``registers`` is the most a thread may
    use under the launch bounds; ``smem_bytes`` of shared memory hold the
    staged tables and axis values (0: read where they lie, a block a tile
    of ``threads * configs`` indices; else the blocks step over the
    tiles)."""

    threads: int
    configs: int
    blocks: int
    registers: int
    index_bits: int
    smem_bytes: int


def eval_registers() -> int:
    """Kernel B's register cap: what ``__launch_bounds__(EVAL_THREADS,
    EVAL_MIN_BLOCKS)`` leaves a thread, in the allocation's units of 8."""
    return min(MAX_REGISTERS,
               SM_REGISTERS // (EVAL_THREADS * EVAL_MIN_BLOCKS) // 8 * 8)


#: Most shared memory kernel B stages a block: what leaves room for
#: EVAL_MIN_BLOCKS blocks an SM.
EVAL_STAGE_MAX = SMEM_PER_SM // EVAL_MIN_BLOCKS - SMEM_RESERVED


@functools.lru_cache(maxsize=256)
def eval_plan(n: int, nf: int, n_total: int | None = None,
              stage_bytes: int = 0) -> EvalPlan:
    """Kernel B's launch for ``n`` indices of ``nf`` channels each into a
    grid of ``n_total`` configurations (default ``n``, the dense
    engine's), whose tables and axis values take ``stage_bytes``.  Where
    :data:`EVAL_CONFIGS` indices a thread fill every SM with
    :data:`EVAL_MIN_BLOCKS` blocks of :data:`EVAL_THREADS`, that is the
    plan, and the tables and axes are staged in shared memory (when they
    fit :data:`EVAL_STAGE_MAX`) by as many blocks as the SMs hold, each
    stepping over the tiles; below it one index a thread, read where
    the tables lie, in the largest whole-warp blocks (up to
    :data:`EVAL_THREADS`) that still give each SM a block (32 threads at
    the probe's 4,096).  Indices decode in 32-bit integers below 2³¹
    configurations, else in 64.  ``nf`` is checked; the work a
    configuration is the same for any set of channels."""
    n_total = n if n_total is None else n_total
    if n < 1 or not 1 <= nf <= len(SW.FIELDS) or n_total < 1:
        raise ValueError(f"no plan for {n} indices of {nf} channels into "
                         f"{n_total} configurations")
    if n >= SMS * EVAL_MIN_BLOCKS * EVAL_THREADS * EVAL_CONFIGS:
        threads, configs = EVAL_THREADS, EVAL_CONFIGS
        smem = stage_bytes if stage_bytes <= EVAL_STAGE_MAX else 0
    else:
        threads = min(EVAL_THREADS, max(32, n // SMS // 32 * 32))
        configs, smem = 1, 0
    blocks = -(-n // (threads * configs))
    if smem:
        blocks = min(blocks, SMS * EVAL_MIN_BLOCKS)
    return EvalPlan(threads, configs, blocks, eval_registers(),
                    32 if n_total < 2**31 else 64, smem)


def div_magic(d: int, bits: int) -> tuple[int, int]:
    """``(mul, shr)`` of kernel B's division by ``d`` in ``bits``-bit
    integers (``fast_div`` in the .cu): ``n // d == (n * mul) >> (bits +
    shr)`` for ``0 <= n < 2**(bits - 1)``, with ``mul = ceil(2**p / d)``,
    ``p = bits - 1 + ceil(log2 d)``, ``shr = p - bits`` (Granlund and
    Montgomery; CUTLASS's ``FastDivmod``).  ``mul`` 0 stands for ``d`` =
    1, where the kernel takes ``n`` itself."""
    if d < 1 or bits not in (32, 64):
        raise ValueError(f"no fast division by {d} in {bits} bits")
    if d == 1:
        return 0, 0
    p = bits - 1 + (d - 1).bit_length()
    return -(-(1 << p) // d), p - bits


@functools.lru_cache(maxsize=1)
def _lib():
    lib = LIBRARY.load()
    for fn in (lib.sweep_grid_chunk_launch, lib.sweep_grid_eval_launch,
               lib.sweep_grid_fold_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.sweep_grid_error_string.argtypes = [ctypes.c_int]
    lib.sweep_grid_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn, iargs: list, dargs: list, device: torch.device) -> None:
    ia = np.asarray(iargs, np.int64)
    da = np.asarray(dargs, np.float64)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ia.ctypes.data, ia.size, da.ctypes.data, da.size,
            device.index if device.index is not None else 0, stream)
    if rc != 0:
        msg = _lib().sweep_grid_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} failed: {msg} (code {rc})")


def _check(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _common_args(T: A.DeviceTables, shape, axvals) -> tuple[list, list]:
    """Table offsets, grid geometry and constants — the part of the
    argument list both kernels share (``read_common`` in the .cu)."""
    dev = T.buf.device
    _check(T.buf, "table buffer", torch.float64, dev)
    shape = tuple(int(s) for s in shape)
    if len(shape) != SW.N_INDEX_AXES + 5 or len(axvals) != len(shape):
        raise ValueError(f"expected {SW.N_INDEX_AXES + 5} grid axes, got "
                         f"shape {shape} and {len(axvals)} axis arrays")
    for i, (v, n) in enumerate(zip(axvals, shape)):
        _check(v, f"axis {i}",
               torch.int64 if i < SW.N_INDEX_AXES else torch.float64, dev,
               (n,))
    offs, widths = [], []
    for name in KERNEL_TABLES:
        off, shp = T.index[name]
        offs.append(off)
        widths.append(shp[1] if len(shp) == 2 else 1)
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    iargs = [T.buf.data_ptr(), *offs, *widths,
             *(v.data_ptr() for v in axvals), *shape, *strides,
             int(np.prod(shape))]
    return iargs, list(_CONSTS)


def sweep_grid_chunk(spec, T: A.DeviceTables, axvals, aux, start: int,
                     base=None) -> dict:
    """Kernel A: the block partials of chunk ``[base + start, base + start
    + spec.chunk)`` (:func:`repro_torch.core.backend.chunk_partials`'s
    keys, shapes and dtypes); ``base`` is an optional 0-d int64 tensor on
    the device, read by the kernel (a captured graph replays at the
    ``base`` written before the replay).  CPU tables run the plain
    version.  A launch recorded into a CUDA graph is not counted: the
    graph's replays count theirs (:meth:`CudaGridBackend.
    graph_replayed`)."""
    dev = T.buf.device
    if dev.type == "cpu":
        return ref.chunk_partials_ref(spec, T, axvals, aux, start, base)
    if dev.type != "cuda":
        raise ValueError(f"sweep_grid_chunk runs on cuda or cpu, not {dev}")
    nf, d = len(spec.fields), spec.d
    W, Bn, CP = spec.block, spec.n_blocks, spec.padded
    if len(spec.cons_static) > MAX_CONS or spec.filter_rows > MAX_ROWS:
        raise ValueError(f"kernel A takes at most {MAX_CONS} constraints "
                         f"and {MAX_ROWS} filter rows")
    plan = chunk_plan(spec)
    iargs, dargs = _common_args(T, spec.shape, axvals)
    filt = aux["filter"]
    _check(filt["rows"], "filter rows", torch.float64, dev,
           (spec.filter_rows, d))
    table_dims = d - 1 if "table" in filt else 0
    if table_dims:
        bins = filt["edges"].shape[1] - 1
        _check(filt["edges"], "filter edges", torch.float64, dev,
               (d - 1, bins + 1))
        _check(filt["table"], "filter table", torch.float64, dev,
               (bins + 1,) * (d - 1))
        if not 2 <= d <= 3 or bins != spec.filter_bins:
            raise ValueError(f"the prefix-min table needs 2 <= d <= 3 and "
                             f"{spec.filter_bins} bins, got d = {d} and "
                             f"{bins} bins")
        edges, table = filt["edges"].data_ptr(), filt["table"].data_ptr()
    else:
        bins, edges, table = 0, 0, 0
    base_ptr = 0
    if base is not None:
        _check(base, "base", torch.int64, dev, ())
        base_ptr = base.data_ptr()
    cons_ptr = 0
    if spec.cons_static:
        _check(aux["cons"], "constraint bounds", torch.float64, dev,
               (len(spec.cons_static),))
        cons_ptr = aux["cons"].data_ptr()

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {
        "Fd": empty((d, CP), torch.float64),
        "Fsg": empty((d, CP), torch.float64),
        "valid": empty((d, CP), torch.bool),
        "keep": empty((CP,), torch.bool),
        "bmin": empty((nf, Bn), torch.float64),
        "bidx": empty((nf, Bn), torch.int64),
        "cnt": empty((nf, Bn), torch.int32),
        "bmax": empty((nf, Bn), torch.float64),
        "sgmin": empty((d, Bn), torch.float64),
    }
    iargs += [int(start), base_ptr, spec.chunk, CP, W, Bn,
              int(spec.small_index),
              nf, d, *(SW.FIELDS.index(f) for f in spec.fields),
              len(spec.cons_static),
              *(fi for fi, _ in spec.cons_static),
              *(_OPS[op] for _, op in spec.cons_static), cons_ptr,
              spec.filter_rows, filt["rows"].data_ptr(), table_dims, bins,
              edges, table,
              *(out[k].data_ptr() for k in ("Fd", "Fsg", "valid", "keep",
                                            "bmin", "bidx", "cnt", "bmax",
                                            "sgmin")),
              plan.threads, plan.lanes, plan.smem_bytes]
    dargs += [float(s) for s in spec.sign]
    _launch(_lib().sweep_grid_chunk_launch, iargs, dargs, dev)
    if not torch.cuda.is_current_stream_capturing():
        sweep_grid_chunk.launches += 1
    return out


sweep_grid_chunk.launches = 0


def stage_bytes(T: A.DeviceTables, shape) -> int:
    """Shared memory kernel B stages: the table buffer and every axis's
    values, 8 bytes each."""
    return 8 * (T.buf.numel() + sum(int(s) for s in shape))


def decode_args(shape, bits: int) -> list:
    """Kernel B's decode as its launcher reads it: ``(mul, shr)`` of
    :func:`div_magic` for each axis's stride, then for each axis's size,
    a 64-bit ``mul`` at or above 2⁶³ as the int64 of its bits."""
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    out = []
    for d in (*strides, *shape):
        mul, shr = div_magic(int(d), bits)
        out += [mul - (mul >> 63 << 64), shr]
    return out


def sweep_grid_eval(T: A.DeviceTables, shape, fields, axvals, flat,
                    plan: EvalPlan | None = None) -> dict:
    """Kernel B: ``fields`` at the flat grid indices ``flat`` (int64, in
    ``[0, prod(shape))``), as ``{field: (n,) float64}``, launched by
    ``plan`` (default :func:`eval_plan`'s; the launcher refuses one this
    build does not run).  CPU tables run the plain version."""
    dev = T.buf.device
    fields = tuple(fields)
    if dev.type == "cpu":
        return ref.sweep_grid_eval_ref(T, shape, fields, axvals, flat)
    if dev.type != "cuda":
        raise ValueError(f"sweep_grid_eval runs on cuda or cpu, not {dev}")
    n = flat.shape[0]
    _check(flat, "flat", torch.int64, dev, (n,))
    iargs, dargs = _common_args(T, shape, axvals)
    # one row per distinct channel, in the order first asked for
    rows = {f: i for i, f in enumerate(dict.fromkeys(fields))}
    unknown = sorted(set(rows) - set(SW.FIELDS))
    if unknown:
        raise ValueError(f"unknown channels {unknown}; have {SW.FIELDS}")
    F = torch.empty((len(rows), n), dtype=torch.float64, device=dev)
    if n:
        shape = tuple(int(s) for s in shape)
        plan = plan or eval_plan(n, len(rows), int(np.prod(shape)),
                                 stage_bytes(T, shape))
        iargs += [flat.data_ptr(), n,
                  *(rows.get(f, -1) for f in SW.FIELDS),
                  *decode_args(shape, plan.index_bits),
                  T.buf.numel(), F.data_ptr(), plan.threads, plan.configs,
                  plan.blocks, plan.index_bits, plan.smem_bytes]
        _launch(_lib().sweep_grid_eval_launch, iargs, dargs, dev)
        sweep_grid_eval.launches += 1
    return {f: F[i] for f, i in rows.items()}


sweep_grid_eval.launches = 0


def survivor_rows(spec, rows: int, device) -> tuple:
    """Empty survivor outputs of ``rows`` chunks, the layout of a chunk
    step's: ``(flat (rows, cap) int64, values (rows, cap, d) float64,
    count (rows,) int64)``, ``cap`` the spec's ``survivor_cap``."""
    cap = spec.survivor_cap
    return (torch.empty((rows, cap), dtype=torch.int64, device=device),
            torch.empty((rows, cap, spec.d), dtype=torch.float64,
                        device=device),
            torch.empty((rows,), dtype=torch.int64, device=device))


def sweep_grid_fold(spec, carry: dict, partials: dict, aux: dict,
                    start: int, base=None, out=None, row: int = 0) -> tuple:
    """Kernel F: fold the partials of chunk ``[base + start, base + start
    + spec.chunk)`` (kernel A's) into the device carry ``carry``
    (:func:`repro_torch.core.backend.init_carry`'s keys), in place, and
    write the chunk's survivors into row ``row`` of ``out``
    (:func:`survivor_rows`; one row made when ``None``), which it
    returns.  ``base`` is an optional 0-d int64 tensor on the device,
    read by the kernel.  Row ``row`` then holds what ``fold_chunk``
    returns in its first ``min(count, cap)`` entries; the kernel leaves
    the rest unwritten.  CPU tensors run the plain version
    (``fold_chunk``), which writes the whole row.  A launch recorded
    into a CUDA graph is not counted: the graph's replays count theirs
    (:meth:`CudaGridBackend.graph_replayed`)."""
    dev = partials["bmin"].device
    if out is None:
        out = survivor_rows(spec, 1, dev)
    if dev.type == "cpu":
        new, surv = ref.fold_chunk_ref(
            spec, carry, partials, aux, start if base is None
            else base + start)
        for key, v in new.items():
            carry[key].copy_(v)
        for o, s in zip(out, surv):
            o[row].copy_(s)
        return out
    if dev.type != "cuda":
        raise ValueError(f"sweep_grid_fold runs on cuda or cpu, not {dev}")
    plan = fold_plan(spec)
    nf, d, k, bins = len(spec.fields), spec.d, spec.k, spec.hist_bins
    Bn, CP, cap = spec.n_blocks, spec.padded, spec.survivor_cap
    f64, i64 = torch.float64, torch.int64
    for key, dtype, shape in (
            ("bmin", f64, (nf, Bn)), ("bidx", i64, (nf, Bn)),
            ("cnt", torch.int32, (nf, Bn)), ("bmax", f64, (nf, Bn)),
            ("sgmin", f64, (d, Bn)), ("Fsg", f64, (d, CP)),
            ("Fd", f64, (d, CP)), ("valid", torch.bool, (d, CP)),
            ("keep", torch.bool, (CP,))):
        _check(partials[key], key, dtype, dev, shape)
    carry_keys = [("min_val", f64, (nf,)), ("min_idx", i64, (nf,)),
                  ("finite", i64, (nf,)), ("fmin", f64, (nf,)),
                  ("fmax", f64, (nf,)), ("topk_val", f64, (d, k)),
                  ("topk_idx", i64, (d, k))]
    edges = hist = 0
    if bins:
        carry_keys.append(("hist", i64, (d, bins)))
        _check(aux["hist_edges"], "hist_edges", f64, dev, (d, bins + 1))
        edges, hist = aux["hist_edges"].data_ptr(), carry["hist"].data_ptr()
    for key, dtype, shape in carry_keys:
        _check(carry[key], f"carry {key}", dtype, dev, shape)
    if partials["keep"].data_ptr() % 16:
        raise ValueError("kernel F reads the keep mask in 16-byte words: "
                         "it must start 16-byte aligned")
    flat, vals, count = out
    rows = flat.shape[0]
    _check(flat, "survivor flat", i64, dev, (rows, cap))
    _check(vals, "survivor values", f64, dev, (rows, cap, d))
    _check(count, "survivor count", i64, dev, (rows,))
    if not 0 <= row < rows:
        raise ValueError(f"row {row} outside the {rows} survivor rows")
    base_ptr = 0
    if base is not None:
        _check(base, "base", i64, dev, ())
        base_ptr = base.data_ptr()
    iargs = [int(start), base_ptr, spec.chunk, CP, cap, Bn,
             spec.block, nf, d, k, spec.nb, bins,
             *(partials[key].data_ptr() for key in (
                 "bmin", "bidx", "cnt", "bmax", "sgmin", "Fsg", "Fd",
                 "valid", "keep")),
             edges,
             *(carry[key].data_ptr() for key in (
                 "min_val", "min_idx", "finite", "fmin", "fmax",
                 "topk_val", "topk_idx")),
             hist, flat[row].data_ptr(), vals[row].data_ptr(),
             count[row].data_ptr(), plan.threads, plan.blocks, plan.lists,
             plan.smem_bytes]
    _launch(_lib().sweep_grid_fold_launch, iargs, [], dev)
    if not torch.cuda.is_current_stream_capturing():
        sweep_grid_fold.launches += 1
    return out


sweep_grid_fold.launches = 0
