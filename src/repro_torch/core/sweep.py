"""Vectorized design-space engine: Eqs. 1-11 over flat lane tensors.

The PyTorch counterpart of the reference ``repro.core.sweep``.  The
per-configuration model (:func:`config_eval`) is written once over flat
"lane" tensors (one entry per configuration; a batch dimension written
out instead of ``vmap``), in exactly the operation order of the
reference kernel, in float64.  It is the *plain* version of the model:
the CUDA kernels of :mod:`repro_torch.kernels.sweep_grid` evaluate the
same expression, operation for operation, in one ``__device__``
function, and are held against this module on the card.

Grid axes of :func:`evaluate_grid` (cartesian product, in order)::

    cut               partition index over DetNet ++ KeyNet layer list
    agg_node          aggregator tech node        ("7nm" | "16nm" | TechNode)
    sensor_node       on-sensor tech node
    weight_mem        on-sensor weight memory     ("sram" | "mram")
    detnet_fps        DetNet rate (the ROI-reuse knob)
    keynet_fps        KeyNet rate
    num_cameras       camera count
    mipi_energy_scale multiplier on MIPI pJ/B (Eq. 5 sensitivity axis)
    camera_fps        frame delivery rate

Invalid configurations (MRAM weight memory on a node with no MRAM test
vehicle, with an on-sensor deployment present) evaluate to NaN.  All
arithmetic is explicit ``torch.float64``; torch's global default dtype
is never changed.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
import re
from collections import OrderedDict
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from . import arrays as A
from .constants import (CAMERA_FPS, DETNET_FPS, KEYNET_FPS, NUM_CAMERAS,
                        TechNode)
from .workloads import NNWorkload

F64 = torch.float64

AXIS_NAMES = ("cut", "agg_node", "sensor_node", "weight_mem", "detnet_fps",
              "keynet_fps", "num_cameras", "mipi_energy_scale", "camera_fps")

#: Name of the optional leading axis over stacked workload batches.
MODEL_AXIS = "model"

#: Number of leading integer (table-index) axes in the kernel's axis
#: tuple: model, cut, agg node, sensor node, weight memory.  The five
#: after them are float64 knob values.
N_INDEX_AXES = 5

#: Output fields of the model (each becomes one grid-shaped array).
FIELDS = ("avg_power", "camera", "utsv", "mipi", "sensor_compute",
          "sensor_memory", "agg_compute", "agg_memory", "mipi_bytes_per_s",
          "sensor_macs_per_s", "latency")

#: Comparison operators a constraint predicate may use.
CONSTRAINT_OPS: Mapping[str, callable] = {
    "<=": operator.le, ">=": operator.ge, "<": operator.lt, ">": operator.gt}

_CONSTRAINT_RE = re.compile(
    r"\s*(\w+)\s*(<=|>=|<|>)\s*([-+]?[\d.]+(?:[eE][-+]?\d+)?)\s*")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    every public entry point) requires a CUDA device: without one this
    raises instead of quietly running on the CPU, which only an explicit
    ``device="cpu"`` selects."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def parse_constraints(constraints) -> tuple[tuple[str, str, float], ...]:
    """Canonicalize a constraint spec into ``((field, op, bound), ...)``.

    Accepted forms: a mapping ``{field: bound}`` (upper bounds), a
    mapping ``{field: (op, bound)}``, or an iterable of ``"field <=
    bound"`` strings or ``(field, op, bound)`` tuples.  NaN channel
    values (invalid configurations) never satisfy a predicate.
    """
    if not constraints:
        return ()
    items: list[tuple[str, str, float]] = []
    if isinstance(constraints, Mapping):
        for field, spec in constraints.items():
            if isinstance(spec, (tuple, list)):
                if len(spec) != 2:
                    raise ValueError(f"constraint {field!r}: expected "
                                     f"(op, bound), got {spec!r}")
                op, bound = spec
            else:
                op, bound = "<=", spec
            items.append((field, op, bound))
    else:
        for c in constraints:
            if isinstance(c, str):
                m = _CONSTRAINT_RE.fullmatch(c)
                if not m:
                    raise ValueError(
                        f"cannot parse constraint {c!r}; expected "
                        f"'<field> <op> <value>' with op in "
                        f"{tuple(CONSTRAINT_OPS)}")
                items.append((m.group(1), m.group(2), m.group(3)))
            else:
                field, op, bound = c
                items.append((field, op, bound))
    out = []
    for field, op, bound in items:
        if field not in FIELDS:
            raise ValueError(f"unknown constraint channel {field!r}; "
                             f"kernel channels are {FIELDS}")
        if op not in CONSTRAINT_OPS:
            raise ValueError(f"unknown constraint op {op!r}; "
                             f"have {tuple(CONSTRAINT_OPS)}")
        out.append((field, op, float(bound)))
    return tuple(out)


def constraint_mask(data: Mapping[str, np.ndarray],
                    constraints) -> np.ndarray:
    """Boolean feasibility mask of a channel dict under a constraint spec
    (host twin of the chunk kernel's predicate mask).  NaN channel values
    fail every predicate."""
    cons = parse_constraints(constraints)
    mask = np.ones(np.shape(next(iter(data.values()))), bool)
    with np.errstate(invalid="ignore"):
        for field, op, bound in cons:
            mask &= CONSTRAINT_OPS[op](np.asarray(data[field]), bound)
    return mask


# ---------------------------------------------------------------------------
# The per-configuration model over flat lane tensors (plain version)
# ---------------------------------------------------------------------------

# Every division below is tensor / tensor on the lanes' device: on CUDA,
# PyTorch turns ``tensor / python_scalar`` into a multiplication by the
# scalar's reciprocal, and ``scalar / tensor`` into ``reciprocal * scalar``
# on any device — neither is the IEEE quotient the reference (and the
# CUDA kernel) computes.


def _div(a, b):
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def _where(cond, a, b):
    """``jnp.where`` with float64 scalars kept float64 (a Python-float
    branch of ``torch.where`` would otherwise take the default dtype)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full(cond.shape, a, dtype=F64, device=cond.device)
    return torch.where(cond, a, b)


def _site_power(macs_per_s, w_read_per_s, act_per_s, cycles_per_s, f_clk,
                e_mac, wm_e_read, wm_leak_on, wm_leak_ret, sram_e_read,
                sram_e_write, sram_leak_on, sram_leak_ret, cap_w, cap_a,
                l1_bytes):
    """Eqs. 7-11 for one processor site, per-second accounting: compute
    (Eq. 7), L2-weight / L2-activation / L1 access energy (Eq. 8), and
    On/Retention leakage of the three memory instances (Eqs. 9-11)."""
    p_compute = macs_per_s * e_mac

    act_read = act_per_s / 2
    act_write = act_per_s / 2
    # L1 sees every streamed byte once more (L2 -> L1 -> engine).
    l1_traffic = w_read_per_s + act_read + act_write
    p_l2w = w_read_per_s * wm_e_read
    p_l2a = act_read * sram_e_read + act_write * sram_e_write
    p_l1 = (l1_traffic / 2 * (A.L1_ENERGY_SCALE * sram_e_read)
            + l1_traffic / 2 * (A.L1_ENERGY_SCALE * sram_e_write))

    t_proc = torch.minimum(torch.ones_like(cycles_per_s),
                           _div(cycles_per_s, f_clk))
    t_idle = torch.maximum(torch.zeros_like(t_proc), 1.0 - t_proc)
    p_leak = (cap_w * (wm_leak_on * t_proc + wm_leak_ret * t_idle)
              + cap_a * (sram_leak_on * t_proc + sram_leak_ret * t_idle)
              + l1_bytes * (sram_leak_on * t_proc + sram_leak_ret * t_idle))
    return p_compute, p_l2w + p_l2a + p_l1 + p_leak


def config_eval(T, model_i, cut, agg_i, sen_i, wm_i, det_fps, key_fps, ncam,
                mipi_scale, cam_fps) -> dict:
    """Eq. 1-11 for every lane: the plain PyTorch version of the model.

    ``T`` is the device table set (:func:`repro_torch.core.arrays.
    tables_to_device`); the five index arguments are int64 lane tensors
    and the five knob arguments float64 lane tensors, all of one length
    and on ``T``'s device.  Returns ``{field: (n,) float64}`` for every
    field of :data:`FIELDS`.
    """
    m = model_i

    def det(name, i):
        return T["det." + name][m, i]

    def key(name, i):
        return T["key." + name][m, i]

    def pay(name):
        return T[name][m, cut]

    n_det = T["det.n_layers"][m].long()
    n_key = T["key.n_layers"][m].long()
    n_all = n_det + n_key
    zero = torch.zeros_like(cut)
    cd = torch.minimum(torch.maximum(cut, zero), n_det)   # DetNet on-sensor
    ck = torch.minimum(torch.maximum(cut - n_det, zero), n_key)
    has_sensor = cut > 0
    has_agg = cut < n_all
    f_sen, f_agg = T["f_clk"][sen_i], T["f_clk"][agg_i]

    # ---- Eq. 3/4: cameras (readout window set by camera-side link) ----
    t_comm_cam = _where(has_sensor, A.FULL_FRAME / A.UTSV_BW,
                        A.FULL_FRAME / A.MIPI_BW)
    t_off = torch.maximum(torch.zeros_like(cam_fps),
                          _div(1.0, cam_fps) - A.T_SENSE - t_comm_cam)
    e_cam = (A.CAMERA_SENSE_W * A.T_SENSE + A.CAMERA_READ_W * t_comm_cam
             + A.CAMERA_IDLE_W * t_off)
    p_camera = e_cam * cam_fps * ncam

    # ---- Eq. 5: uTSV readout link (distributed only) ----
    p_utsv = _where(has_sensor,
                    A.FULL_FRAME * A.UTSV_E_PER_BYTE * cam_fps * ncam, 0.0)

    # ---- Eq. 5: MIPI payload plan for this cut ----
    bps_per_cam = (pay("pay_cam_rate") * cam_fps
                   + pay("pay_det_rate") * det_fps
                   + pay("pay_key_rate") * key_fps)
    p_mipi = bps_per_cam * (A.MIPI_E_PER_BYTE * mipi_scale) * ncam
    mipi_bps = bps_per_cam * ncam

    # ---- on-sensor site (x ncam replicas) ----
    macs_s = det("c_macs", cd) * det_fps + key("c_macs", ck) * key_fps
    w_read_s = (det("c_weight_stream", cd) * det_fps
                + key("c_weight_stream", ck) * key_fps)
    act_s = (det("c_act_traffic", cd) * det_fps
             + key("c_act_traffic", ck) * key_fps)
    cyc_s = (det("c_cycles_sensor", cd) * det_fps
             + key("c_cycles_sensor", ck) * key_fps)
    cap_w_s = det("c_weight_bytes", cd) + key("c_weight_bytes", ck)
    cap_a_s = (torch.maximum(det("peak_prefix", cd), key("peak_prefix", ck))
               + T["det.input_bytes"][m])
    p_comp_s, p_mem_s = _site_power(
        macs_s, w_read_s, act_s, cyc_s, f_sen, T["e_mac"][sen_i],
        T["wm_e_read"][sen_i, wm_i], T["wm_leak_on"][sen_i, wm_i],
        T["wm_leak_ret"][sen_i, wm_i],
        T["sram_e_read"][sen_i], T["sram_e_write"][sen_i],
        T["sram_leak_on"][sen_i], T["sram_leak_ret"][sen_i],
        cap_w_s, cap_a_s, A.SENSOR_L1_BYTES)
    p_sensor_compute = _where(has_sensor, p_comp_s * ncam, 0.0)
    p_sensor_memory = _where(has_sensor, p_mem_s * ncam, 0.0)

    # ---- aggregator site (suffix of each network, rate x ncam) ----
    def suffix(name):
        return ((det(name, n_det) - det(name, cd)) * (det_fps * ncam)
                + (key(name, n_key) - key(name, ck)) * (key_fps * ncam))

    macs_a = suffix("c_macs")
    w_read_a = suffix("c_weight_stream")
    act_a = suffix("c_act_traffic")
    cyc_a = suffix("c_cycles_agg")
    cap_w_a = ((det("c_weight_bytes", n_det) - det("c_weight_bytes", cd))
               + (key("c_weight_bytes", n_key) - key("c_weight_bytes", ck)))
    cap_a_a = (torch.maximum(det("peak_suffix", cd), key("peak_suffix", ck))
               + pay("pay_max") * ncam)
    p_comp_a, p_mem_a = _site_power(
        macs_a, w_read_a, act_a, cyc_a, f_agg, T["e_mac"][agg_i],
        # the aggregator's weight memory is always its node SRAM
        T["sram_e_read"][agg_i], T["sram_leak_on"][agg_i],
        T["sram_leak_ret"][agg_i],
        T["sram_e_read"][agg_i], T["sram_e_write"][agg_i],
        T["sram_leak_on"][agg_i], T["sram_leak_ret"][agg_i],
        cap_w_a, cap_a_a, A.AGG_L1_BYTES)
    p_agg_compute = _where(has_agg, p_comp_a, 0.0)
    p_agg_memory = _where(has_agg, p_mem_a, 0.0)

    # ---- end-to-end result latency (cut_latency, lowered: Eq. 6/9) ----
    det_amort = torch.minimum(torch.ones_like(det_fps),
                              _div(det_fps, cam_fps))
    t_det_sen = _div(det("c_cycles_sensor", cd), f_sen) * det_amort
    t_det_agg = _div(det("c_cycles_agg", n_det) - det("c_cycles_agg", cd),
                     f_agg) * det_amort
    t_key_sen = _div(key("c_cycles_sensor", ck), f_sen)
    t_key_agg = _div(key("c_cycles_agg", n_key) - key("c_cycles_agg", ck),
                     f_agg)
    t_comm_cut = _div(pay("pay_det_rate") * det_amort + pay("pay_key_rate"),
                      A.MIPI_BW)
    latency = (A.T_SENSE + t_comm_cam + t_det_sen + t_det_agg
               + t_comm_cut + (ncam - 1.0) * (t_det_agg + t_key_agg)
               + t_key_sen + t_key_agg)

    # Invalid (node, weight-mem) corners poison every objective channel:
    # the power fields inherit NaN from the wm_* tables, the rest get it
    # here.  A cut beyond this model's own cut range (stacked models)
    # poisons every channel (an exact +0.0 for in-range cuts).
    invalid = _where(has_sensor, T["wm_e_read"][sen_i, wm_i] * 0.0, 0.0)
    pad = _where(cut <= n_all, 0.0, float("nan"))
    invalid = invalid + pad

    total = (p_camera + p_utsv + p_mipi + p_sensor_compute
             + p_sensor_memory + p_agg_compute + p_agg_memory)
    return {
        "avg_power": total + pad,
        "camera": p_camera + pad,
        "utsv": p_utsv + pad,
        "mipi": p_mipi + pad,
        "sensor_compute": p_sensor_compute + pad,
        "sensor_memory": p_sensor_memory + pad,
        "agg_compute": p_agg_compute + pad,
        "agg_memory": p_agg_memory + pad,
        "mipi_bytes_per_s": mipi_bps + invalid,
        "sensor_macs_per_s": (_where(has_sensor, macs_s * ncam, 0.0)
                              + invalid),
        "latency": latency + invalid,
    }


# ---------------------------------------------------------------------------
# Flat-index coordinate decoding
# ---------------------------------------------------------------------------


def decode_flat_index(shape: Sequence[int], flat):
    """Mixed-radix decode of C-order flat indices into per-axis indices.

    ``flat`` may be a Python int, a numpy array or a torch tensor; one
    index per axis comes back, in axis order.  Index spaces beyond int32
    are guarded: a narrow integer array is promoted to int64 before the
    stride arithmetic, so ``flat // stride`` can never overflow.
    """
    strides = []
    s = 1
    for size in reversed(shape):
        strides.append(s)
        s *= int(size)
    strides.reverse()
    if s > np.iinfo(np.int32).max:
        if isinstance(flat, torch.Tensor):
            if not flat.dtype.is_floating_point and flat.dtype.itemsize < 8:
                flat = flat.to(torch.int64)
        elif hasattr(flat, "dtype"):
            dt = np.dtype(flat.dtype)
            if np.issubdtype(dt, np.integer) and dt.itemsize < 8:
                flat = flat.astype(np.int64)
    return tuple((flat // stride) % size
                 for stride, size in zip(strides, shape))


def config_from_flat(shape: Sequence[int],
                     axes: "OrderedDict[str, tuple]",
                     flat_index: int) -> dict:
    """Axis values of one flat C-order grid index (shared by the dense
    ``SweepResult`` and the streaming ``StreamResult``)."""
    n = int(np.prod(shape))
    if not 0 <= flat_index < n:
        raise IndexError(f"flat index {flat_index} outside [0, {n})")
    idx = decode_flat_index(shape, int(flat_index))
    return {name: vals[i] for (name, vals), i in zip(axes.items(), idx)}


def _fully_invalid_axis_values(nan_mask: np.ndarray,
                               axes: "OrderedDict[str, tuple]") -> list[str]:
    """``name=value`` notes for axis values whose whole hyperplane is NaN."""
    notes = []
    for ax, (name, vals) in enumerate(axes.items()):
        for i, v in enumerate(vals):
            if np.take(nan_mask, i, axis=ax).all():
                notes.append(f"{name}={v!r}")
    return notes


def invalid_message(field: str, notes: Sequence[str]) -> str:
    """Shared all-invalid error text (dense and streaming paths)."""
    detail = ("; fully-invalid axis values: " + ", ".join(notes)
              if notes else "")
    return (f"every grid configuration is invalid (all-NaN) in channel "
            f"{field!r} — check the weight_mem / sensor_node combinations "
            f"against the available memory test vehicles and the cut range "
            f"of each stacked model{detail}")


# ---------------------------------------------------------------------------
# Grid evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Dense grid of Eq. 1/2 evaluations (host numpy arrays).

    ``axes`` maps axis name -> the axis values (in grid order); every array
    in ``data`` has shape ``tuple(len(v) for v in axes.values())``.  Grids
    evaluated with a stacked workload batch carry a leading ``model`` axis.
    """

    axes: "OrderedDict[str, tuple]"
    data: Mapping[str, np.ndarray]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(v) for v in self.axes.values())

    @property
    def n_configs(self) -> int:
        return int(np.prod(self.shape))

    @property
    def avg_power(self) -> np.ndarray:
        return self.data["avg_power"]

    @property
    def latency(self) -> np.ndarray:
        return self.data["latency"]

    @property
    def mipi_bytes_per_s(self) -> np.ndarray:
        return self.data["mipi_bytes_per_s"]

    def config_at(self, flat_index: int) -> dict:
        return config_from_flat(self.shape, self.axes, flat_index)

    def argmin(self, field: str = "avg_power") -> dict:
        """Best (lowest-``field``) configuration; NaN entries ignored, the
        first minimum wins."""
        arr = self.data[field]
        nan = np.isnan(arr)
        if nan.all():
            raise ValueError(invalid_message(
                field, _fully_invalid_axis_values(nan, self.axes)))
        flat = int(np.nanargmin(arr))
        out = self.config_at(flat)
        out[field] = float(self.data[field].ravel()[flat])
        return out

    def top_k(self, field: str = "avg_power", k: int = 4) -> list[dict]:
        """The ``k`` best (lowest-``field``) configurations, best first;
        ties broken by flat grid index, NaN entries never appear."""
        vals = self.data[field].ravel().copy()
        nan = np.isnan(vals)
        if nan.all():
            raise ValueError(invalid_message(
                field, _fully_invalid_axis_values(np.isnan(self.data[field]),
                                                  self.axes)))
        vals[nan] = np.inf
        if k * 4 < vals.size and vals.size > 4096:
            kth = np.partition(vals, k - 1)[k - 1]
            sel = np.flatnonzero(vals <= kth)
            order = sel[np.lexsort((sel, vals[sel]))][:k]
        else:
            order = np.argsort(vals, kind="stable")[:k]
        out = []
        for flat in order:
            if not np.isfinite(vals[flat]):
                break
            cfg = self.config_at(int(flat))
            cfg[field] = float(vals[flat])
            out.append(cfg)
        return out

    def channel_bounds(self, field: str) -> tuple[float, float]:
        """(min, max) of the finite entries of one channel."""
        vals = self.data[field].ravel()
        finite = vals[np.isfinite(vals)]
        if finite.size == 0:
            raise ValueError(invalid_message(
                field, _fully_invalid_axis_values(np.isnan(self.data[field]),
                                                  self.axes)))
        return float(finite.min()), float(finite.max())

    def breakdown_at(self, flat_index: int) -> dict[str, float]:
        return {f: float(self.data[f].ravel()[flat_index])
                for f in self.data}

    def constrain(self, constraints) -> "SweepResult":
        """Dense post-filter twin of ``stream_grid(constraints=...)``:
        every channel NaN wherever any predicate fails."""
        cons = parse_constraints(constraints)
        if not cons:
            return self
        mask = constraint_mask(self.data, cons)
        data = {f: np.where(mask, a, np.nan)
                for f, a in self.data.items()}
        return SweepResult(axes=self.axes, data=data)


def _node_axis(S: A.StackedModelArrays,
               nodes: Sequence[str | TechNode]) -> tuple[np.ndarray, tuple]:
    idx = np.asarray([S.node_index(n) for n in nodes], np.int32)
    labels = tuple(n if isinstance(n, str) else n.name for n in nodes)
    return idx, labels


def build_axes(cuts=None, agg_nodes=("7nm",), sensor_nodes=("7nm",),
               weight_mems=("sram",), detnet_fps=(DETNET_FPS,),
               keynet_fps=(KEYNET_FPS,), num_cameras=(NUM_CAMERAS,),
               mipi_energy_scale=(1.0,), camera_fps=(CAMERA_FPS,),
               detnet=None, keynet=None, model=None, models=None,
               scenarios=None):
    """Validate and lower the grid axes (shared by dense and streaming).

    Returns ``(S, axis_arrays, axes)``: the stacked model lowering, the
    per-axis numpy index/value arrays *including a leading model axis*,
    and the user-facing axis dict (with ``model`` only when a workload
    batch was requested).  Every index axis is validated against the
    tables it indexes (cuts below ``n_cuts_max``, known nodes and weight
    memories), so no gather of the model — in the plain version or in
    the kernels — can leave its table.
    """
    if scenarios is not None:
        raise NotImplementedError(
            "scenarios= (the session engine) is not ported yet; it "
            "arrives with the scenario-engine slice of the PyTorch port")
    if models is not None:
        if model is not None or detnet is not None or keynet is not None:
            raise ValueError("pass either models= or a single "
                             "detnet/keynet/model, not both")
        S = (models if isinstance(models, A.StackedModelArrays)
             else A.stacked_model_arrays(models))
    elif model is not None:
        S = A.stack_model_arrays((model,))
    else:
        S = A.stack_model_arrays((A.model_arrays(detnet, keynet),))

    model_ax = np.arange(S.n_models, dtype=np.int32)
    if cuts is None:
        cut_ax = np.arange(S.n_cuts_max, dtype=np.int32)
    else:
        cut_ax = np.asarray(list(cuts), np.int32)
        if cut_ax.size and (cut_ax.min() < 0
                            or cut_ax.max() >= S.n_cuts_max):
            raise ValueError(f"cuts outside [0, {S.n_cuts_max - 1}]")
    agg_idx, agg_labels = _node_axis(S, agg_nodes)
    sen_idx, sen_labels = _node_axis(S, sensor_nodes)
    for m in weight_mems:
        if m not in A.WEIGHT_MEM_KINDS:
            raise ValueError(f"unknown weight_mem {m!r}; "
                             f"have {A.WEIGHT_MEM_KINDS}")
    wm_idx = np.asarray([A.WEIGHT_MEM_KINDS.index(m) for m in weight_mems],
                        np.int32)
    f64 = functools.partial(np.asarray, dtype=np.float64)
    float_axes = [f64(list(detnet_fps)), f64(list(keynet_fps)),
                  f64(list(num_cameras)), f64(list(mipi_energy_scale)),
                  f64(list(camera_fps))]
    if float_axes[2].size and (float_axes[2].min() < 1
                               or (float_axes[2] % 1 != 0).any()):
        raise ValueError("num_cameras must be integers >= 1")

    axis_arrays = [model_ax, cut_ax, agg_idx, sen_idx, wm_idx, *float_axes]
    if 0 in (a.size for a in axis_arrays):
        raise ValueError("every grid axis needs at least one value")
    labels = (tuple(int(c) for c in cut_ax), agg_labels, sen_labels,
              tuple(weight_mems), tuple(float_axes[0]), tuple(float_axes[1]),
              tuple(float_axes[2]), tuple(float_axes[3]),
              tuple(float_axes[4]))
    if models is not None:
        axes = OrderedDict(zip((MODEL_AXIS,) + AXIS_NAMES,
                               (S.model_names,) + labels))
    else:
        axes = OrderedDict(zip(AXIS_NAMES, labels))
    return S, axis_arrays, axes


def axes_to_device(axis_arrays, device) -> tuple:
    """The axis arrays as device tensors: int64 for the index axes,
    float64 for the knob axes (the dtypes the kernels take)."""
    return tuple(
        torch.as_tensor(np.asarray(a, np.int64 if i < N_INDEX_AXES
                                   else np.float64), device=device)
        for i, a in enumerate(axis_arrays))


def evaluate_grid(cuts: Optional[Iterable[int]] = None,
                  agg_nodes: Sequence[str | TechNode] = ("7nm",),
                  sensor_nodes: Sequence[str | TechNode] = ("7nm",),
                  weight_mems: Sequence[str] = ("sram",),
                  detnet_fps: Sequence[float] = (DETNET_FPS,),
                  keynet_fps: Sequence[float] = (KEYNET_FPS,),
                  num_cameras: Sequence[float] = (NUM_CAMERAS,),
                  mipi_energy_scale: Sequence[float] = (1.0,),
                  camera_fps: Sequence[float] = (CAMERA_FPS,),
                  detnet: NNWorkload | None = None,
                  keynet: NNWorkload | None = None,
                  model: A.ModelArrays | None = None,
                  models=None,
                  scenarios=None,
                  backend: Optional[str] = None,
                  device="cuda") -> SweepResult:
    """Evaluate Eqs. 1-11 over the cartesian product of the given axes.

    The grid runs as one big chunk of the evaluation-backend contract
    (:mod:`repro_torch.core.backend`): flat indices are decoded to
    coordinates on the device.  ``backend=None`` picks ``"cuda"`` (the
    hand-written kernel) on a CUDA device and ``"torch"`` (the plain
    version) on the CPU.  Returns a :class:`SweepResult` of host arrays
    indexed ``[cut, agg, sensor, wmem, dfps, kfps, ncam, mipi_scale,
    cam_fps]`` (with a leading ``model`` axis when ``models`` is given).
    """
    from . import backend as _backend   # import cycle: backend uses sweep

    dev = resolve_device(device)
    S, axis_arrays, axes = build_axes(
        cuts, agg_nodes, sensor_nodes, weight_mems, detnet_fps, keynet_fps,
        num_cameras, mipi_energy_scale, camera_fps, detnet, keynet, model,
        models, scenarios)
    shape = tuple(len(v) for v in axes.values())
    full_shape = tuple(a.size for a in axis_arrays)
    n = int(np.prod(full_shape))
    evalfn = _backend.cached_dense_eval(backend, S, full_shape, FIELDS, dev)
    out = evalfn(axes_to_device(axis_arrays, dev),
                 torch.arange(n, dtype=torch.int64, device=dev))
    data = {k: v.cpu().numpy().reshape(shape) for k, v in out.items()}
    return SweepResult(axes=axes, data=data)


def scalar_axes(kw: Mapping) -> dict:
    """Map ``partition.evaluate_cut``-style kwargs onto grid axes — the
    one place the kwarg↔axis correspondence is written down (shared by
    :func:`evaluate_one` and ``partition.optimal_partition``).  Scalar
    values become singleton axes; a list/tuple/array value passes through
    as a whole axis, which is how ``optimal_partition`` grows single-knob
    calls into grid (and, past the size threshold, streaming) searches."""
    def ax(name, default):
        v = kw.get(name, default)
        if v is None:
            v = default
        return (tuple(v) if isinstance(v, (list, tuple, np.ndarray))
                else (v,))

    return dict(
        agg_nodes=ax("agg_node", "7nm"),
        sensor_nodes=ax("sensor_node", "7nm"),
        weight_mems=ax("sensor_weight_mem", "sram"),
        detnet_fps=ax("detnet_fps", DETNET_FPS),
        keynet_fps=ax("keynet_fps", KEYNET_FPS),
        num_cameras=ax("num_cameras", NUM_CAMERAS),
        mipi_energy_scale=ax("mipi_energy_scale", 1.0),
        camera_fps=ax("camera_fps", CAMERA_FPS),
        detnet=kw.get("detnet"), keynet=kw.get("keynet"))


def evaluate_one(cut: int, backend: Optional[str] = None, device="cuda",
                 **kw) -> dict[str, float]:
    """Single-configuration convenience wrapper over :func:`evaluate_grid`.

    Scalar keyword arguments match ``partition.evaluate_cut`` (``agg_node``,
    ``sensor_node``, ``sensor_weight_mem``, fps knobs, ...); returns the
    model's field dict for that one point.  Sequence-valued kwargs are
    rejected — grid axes belong to :func:`evaluate_grid` (or
    ``partition.optimal_partition``, which accepts them directly).
    """
    seq = sorted(k for k, v in kw.items()
                 if isinstance(v, (list, tuple, np.ndarray)))
    if seq:
        raise ValueError(f"evaluate_one takes scalar knobs only; {seq} "
                         f"are sequences — use evaluate_grid for axes")
    return evaluate_grid(cuts=(cut,), backend=backend, device=device,
                         **scalar_axes(kw)).breakdown_at(0)
