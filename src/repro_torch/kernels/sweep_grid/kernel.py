"""Hand-written Hopper kernels of the sweep grid: build, binding, wrappers.

Two CUDA C++ kernels in ``csrc/`` (see the note at the top of
``csrc/sweep_grid.cu`` for their design and what bounds them):

* :func:`sweep_grid_chunk` — kernel A, replacing the reference's fused
  Pallas chunk kernel ``repro/kernels/sweep_grid/kernel.py::
  build_chunk_call``: decode + Eq. 1-11 + constraint mask + dominance
  pre-filter + per-block reductions, returning the partials of
  :func:`repro_torch.core.backend.chunk_partials` key for key.
* :func:`sweep_grid_eval` — kernel B, replacing ``_flat_call`` /
  ``sweep_grid_eval`` there: decode + Eq. 1-11 at explicit flat
  indices.

Both call one ``__device__`` function, ``eval_config``, so their values
agree to the bit, and both are compiled with ``--fmad=false`` and IEEE
division so they compute what the plain PyTorch version
(:mod:`.ref`) computes, operation for operation.

The library is built with ``nvcc`` for ``sm_90a`` from the sources in
the checkout at first use (never at import), into ``build/`` at the
root of the checkout, and loaded with ``ctypes``.  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its
kernel on the current stream or raises.  Each wrapper counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
import torch

from repro_torch.core import arrays as A
from repro_torch.core import sweep as SW

from .._build import BASE_FLAGS, Library
from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: The kernels' library.  ``--fmad=false`` keeps every float64 add and
#: multiply a separate IEEE operation, as in the plain version.
LIBRARY = Library("sweep_grid", CSRC, "sweep_grid.cu",
                  ("sweep_grid.cu", "sweep_grid.cuh"),
                  BASE_FLAGS + ("--fmad=false",))

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

@functools.lru_cache(maxsize=1)
def _lib():
    lib = LIBRARY.load()
    for fn in (lib.sweep_grid_chunk_launch, lib.sweep_grid_eval_launch):
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


def sweep_grid_chunk(spec, T: A.DeviceTables, axvals, aux, start: int) -> dict:
    """Kernel A: the block partials of chunk ``[start, start +
    spec.chunk)`` (:func:`repro_torch.core.backend.chunk_partials`'s
    keys, shapes and dtypes).  CPU tables run the plain version."""
    dev = T.buf.device
    if dev.type == "cpu":
        return ref.chunk_partials_ref(spec, T, axvals, aux, start)
    if dev.type != "cuda":
        raise ValueError(f"sweep_grid_chunk runs on cuda or cpu, not {dev}")
    nf, d = len(spec.fields), spec.d
    W, Bn, CP = spec.block, spec.n_blocks, spec.padded
    if len(spec.cons_static) > MAX_CONS or spec.filter_rows > MAX_ROWS:
        raise ValueError(f"kernel A takes at most {MAX_CONS} constraints "
                         f"and {MAX_ROWS} filter rows")
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
        if not 2 <= d <= 3:
            raise ValueError("the prefix-min table needs 2 <= d <= 3")
        edges, table = filt["edges"].data_ptr(), filt["table"].data_ptr()
    else:
        bins, edges, table = 0, 0, 0
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
    iargs += [int(start), spec.chunk, CP, W, Bn, int(spec.small_index),
              nf, d, *(SW.FIELDS.index(f) for f in spec.fields),
              len(spec.cons_static),
              *(fi for fi, _ in spec.cons_static),
              *(_OPS[op] for _, op in spec.cons_static), cons_ptr,
              spec.filter_rows, filt["rows"].data_ptr(), table_dims, bins,
              edges, table,
              *(out[k].data_ptr() for k in ("Fd", "Fsg", "valid", "keep",
                                            "bmin", "bidx", "cnt", "bmax",
                                            "sgmin"))]
    dargs += [float(s) for s in spec.sign]
    _launch(_lib().sweep_grid_chunk_launch, iargs, dargs, dev)
    sweep_grid_chunk.launches += 1
    return out


sweep_grid_chunk.launches = 0


def sweep_grid_eval(T: A.DeviceTables, shape, fields, axvals, flat) -> dict:
    """Kernel B: ``fields`` at the flat grid indices ``flat`` (int64, in
    ``[0, prod(shape))``), as ``{field: (n,) float64}``.  CPU tables run
    the plain version."""
    dev = T.buf.device
    fields = tuple(fields)
    if dev.type == "cpu":
        return ref.sweep_grid_eval_ref(T, shape, fields, axvals, flat)
    if dev.type != "cuda":
        raise ValueError(f"sweep_grid_eval runs on cuda or cpu, not {dev}")
    n = flat.shape[0]
    _check(flat, "flat", torch.int64, dev, (n,))
    iargs, dargs = _common_args(T, shape, axvals)
    F = torch.empty((len(fields), n), dtype=torch.float64, device=dev)
    if n:
        iargs += [flat.data_ptr(), n, len(fields),
                  *(SW.FIELDS.index(f) for f in fields), F.data_ptr()]
        _launch(_lib().sweep_grid_eval_launch, iargs, dargs, dev)
        sweep_grid_eval.launches += 1
    return {f: F[i] for i, f in enumerate(fields)}


sweep_grid_eval.launches = 0
