"""Struct-of-arrays lowering of the semi-analytical model (Eqs. 1-11).

The scalar path (:mod:`repro.core.system` / :mod:`repro.core.partition`)
walks Python dataclasses layer by layer for every configuration.  That is
the right shape for a single, fully-annotated report, but a design-space
sweep evaluates the same per-layer reductions thousands of times with only
a handful of scalar knobs changing.  This module lowers everything that is
*configuration independent* into dense ``float64`` arrays once:

* :class:`WorkloadArrays` — per-network prefix sums over the concatenated
  layer tables: MACs, weight bytes, streamed-weight bytes (the DORY-style
  re-fetch of :func:`repro.core.rbe.weight_stream_bytes`), activation
  traffic, RBE cycles at the on-sensor (1/4) and aggregator (1x) scales,
  and prefix/suffix peaks of the activation footprint.  A partition cut
  then becomes two gathers (prefix = sensor side, suffix = aggregator
  side) instead of a rebuild of ``NNWorkload`` objects.
* :class:`ModelArrays` — the above for DetNet/KeyNet plus stacked tech-node
  and memory-technology tables (``TechNode``/``MemorySpec``), link
  constants (``LinkSpec``), and per-cut MIPI payload tables derived from
  :func:`mipi_payloads` (the single source of truth for what crosses MIPI
  at each cut, shared with the scalar path).

:mod:`repro.core.sweep` consumes a :class:`ModelArrays` inside a
``jax.jit``/``jax.vmap`` kernel; the scalar API consumes the same payload
plan through :func:`mipi_payloads`, so the two paths cannot drift.  The
cycle prefix-sums double as the lowering of the per-cut latency model
(:func:`repro.core.latency.cut_latency` — the kernel's ``latency``
channel), and the per-rate payload tables are shared between the Eq. 5
power term and the latency critical path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from . import rbe
from .constants import (AGG_L1_BYTES, BOX_COORDS_BYTES, DPS_CAMERA,
                        L1_ENERGY_SCALE, MIPI, ON_SENSOR_SCALE, RBE,
                        SENSOR_L1_BYTES, T_SENSE_S, TECH_NODES, UTSV,
                        MemorySpec, TechNode)
from .handtracking import (FULL_FRAME_BYTES, ROI_BYTES, build_detnet,
                           build_keynet)
from .workloads import NNWorkload

# Rate tags for MIPI payloads: each payload crosses the link at one of the
# three system rates (Eq. 2 multiplies by the rate of the producing module).
RATE_CAMERA = "camera"
RATE_DETNET = "detnet"
RATE_KEYNET = "keynet"

# Weight-memory kinds, in table order (axis 1 of the ``wm_*`` tables).
WEIGHT_MEM_KINDS = ("sram", "mram")


def mipi_payloads(cut: int, detnet: NNWorkload,
                  keynet: NNWorkload) -> list[tuple[float, str]]:
    """What crosses MIPI for partition cut ``cut``: ``[(bytes, rate_tag)]``.

    This is the single source of truth for the cut semantics described in
    :mod:`repro.core.partition` — the scalar ``evaluate_cut`` maps the rate
    tags onto fps values, and :func:`model_arrays` folds the same plan into
    per-cut byte tables for the vectorized engine.
    """
    n_det = len(detnet.layers)
    n_all = n_det + len(keynet.layers)
    if not 0 <= cut <= n_all:
        raise ValueError(f"cut {cut} outside [0, {n_all}]")
    if cut == 0:
        # Fully centralized: the raw frame crosses at camera rate.
        return [(FULL_FRAME_BYTES, RATE_CAMERA)]
    if cut < n_det:
        # DetNet split: the cut activation crosses at DetNet rate, boxes
        # return sensor-ward, and the ROI crop still has to cross at
        # KeyNet rate (the raw frame only exists on-sensor).
        act = detnet.layers[cut - 1].out_act_bytes
        return [(act, RATE_DETNET), (BOX_COORDS_BYTES, RATE_DETNET),
                (ROI_BYTES, RATE_KEYNET)]
    if cut == n_det:
        # The paper's split: ROI (KeyNet rate) + DetNet outputs (tiny).
        return [(detnet.output_bytes, RATE_DETNET), (ROI_BYTES, RATE_KEYNET)]
    # KeyNet split: the KeyNet cut activation crosses at KeyNet rate.
    act = keynet.layers[cut - n_det - 1].out_act_bytes
    return [(act, RATE_KEYNET), (detnet.output_bytes, RATE_DETNET)]


# ---------------------------------------------------------------------------
# Per-workload arrays
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class WorkloadArrays:
    """Prefix-sum tables over one network's layer list (all ``float64``).

    Every ``c_*`` array has length ``n_layers + 1`` with ``c[k]`` = the
    reduction over layers ``[0, k)`` — so for a cut that keeps ``k`` layers
    on-sensor, the sensor side reads ``c[k]`` and the aggregator side reads
    ``c[n_layers] - c[k]``.  ``peak_prefix[k]`` / ``peak_suffix[k]`` are the
    running max of the activation footprint over the same ranges.
    """

    name: str
    n_layers: int
    input_bytes: float
    output_bytes: float
    c_macs: np.ndarray            # cumulative MACs per inference
    c_weight_bytes: np.ndarray    # cumulative weight footprint (L2-W capacity)
    c_weight_stream: np.ndarray   # cumulative streamed weight bytes (Eq. 8)
    c_act_traffic: np.ndarray     # cumulative in+out activation bytes (Eq. 8)
    c_cycles_sensor: np.ndarray   # cumulative RBE cycles at ON_SENSOR_SCALE
    c_cycles_agg: np.ndarray      # cumulative RBE cycles at scale 1.0
    peak_prefix: np.ndarray       # max activation footprint, layers [0, k)
    peak_suffix: np.ndarray       # max activation footprint, layers [k, n)
    out_act_bytes: np.ndarray     # per-layer output activation bytes (n,)


def _cumsum0(values: list[float]) -> np.ndarray:
    """Length n+1 prefix sums starting at 0, in float64."""
    return np.concatenate(([0.0], np.cumsum(np.asarray(values, np.float64))))


@functools.lru_cache(maxsize=64)
def workload_arrays(wl: NNWorkload) -> WorkloadArrays:
    """Lower one :class:`NNWorkload` layer table into prefix-sum arrays."""
    layers = wl.layers
    n = len(layers)
    peaks = [float(max(l.in_act_bytes, l.out_act_bytes)) for l in layers]
    peak_prefix = np.zeros(n + 1, np.float64)
    peak_suffix = np.zeros(n + 1, np.float64)
    for k in range(n):
        peak_prefix[k + 1] = max(peak_prefix[k], peaks[k])
        peak_suffix[n - 1 - k] = max(peak_suffix[n - k], peaks[n - 1 - k])
    return WorkloadArrays(
        name=wl.name,
        n_layers=n,
        input_bytes=float(wl.input_bytes),
        output_bytes=float(wl.output_bytes),
        c_macs=_cumsum0([float(l.macs) for l in layers]),
        c_weight_bytes=_cumsum0([float(l.weight_bytes) for l in layers]),
        c_weight_stream=_cumsum0([float(rbe.weight_stream_bytes(l))
                                  for l in layers]),
        c_act_traffic=_cumsum0([float(l.in_act_bytes + l.out_act_bytes)
                                for l in layers]),
        c_cycles_sensor=_cumsum0(
            [l.macs / rbe.mac_per_cycle(l, RBE, ON_SENSOR_SCALE)
             for l in layers]),
        c_cycles_agg=_cumsum0([l.macs / rbe.mac_per_cycle(l, RBE, 1.0)
                               for l in layers]),
        peak_prefix=peak_prefix,
        peak_suffix=peak_suffix,
        out_act_bytes=np.asarray([float(l.out_act_bytes) for l in layers],
                                 np.float64),
    )


# ---------------------------------------------------------------------------
# Technology tables
# ---------------------------------------------------------------------------


def _mem_fields(mem: Optional[MemorySpec]) -> tuple[float, float, float,
                                                    float]:
    if mem is None:
        return (np.nan, np.nan, np.nan, np.nan)
    return (mem.e_read, mem.e_write, mem.leak_on, mem.leak_ret)


@dataclasses.dataclass(frozen=True, eq=False)
class ModelArrays:
    """Everything the jit/vmap kernel needs, as dense constant arrays."""

    det: WorkloadArrays
    key: WorkloadArrays
    node_names: tuple[str, ...]

    # Logic-node tables, shape (n_nodes,)
    e_mac: np.ndarray
    f_clk: np.ndarray
    # Activation-SRAM tables, shape (n_nodes,)
    sram_e_read: np.ndarray
    sram_e_write: np.ndarray
    sram_leak_on: np.ndarray
    sram_leak_ret: np.ndarray
    # Weight-memory tables, shape (n_nodes, len(WEIGHT_MEM_KINDS)); NaN
    # where the (node, kind) pair has no test vehicle — NaN propagation
    # through these fields is what marks invalid grid corners.
    wm_e_read: np.ndarray
    wm_leak_on: np.ndarray
    wm_leak_ret: np.ndarray

    # Per-cut MIPI payload tables, shape (n_cuts,) = n_det + n_key + 1.
    pay_cam_rate: np.ndarray      # bytes crossing at camera rate
    pay_det_rate: np.ndarray      # bytes crossing at DetNet rate
    pay_key_rate: np.ndarray      # bytes crossing at KeyNet rate
    pay_max: np.ndarray           # largest single payload (agg input buffer)

    @property
    def n_cuts(self) -> int:
        return self.det.n_layers + self.key.n_layers + 1

    def node_index(self, node: str | TechNode) -> int:
        name = node if isinstance(node, str) else node.name
        try:
            return self.node_names.index(name)
        except ValueError:
            raise KeyError(f"unknown tech node {name!r}; "
                           f"have {self.node_names}") from None


@functools.lru_cache(maxsize=16)
def model_arrays(detnet: NNWorkload | None = None,
                 keynet: NNWorkload | None = None) -> ModelArrays:
    """Build (and cache) the full constant table set for one workload pair.

    ``None`` selects the canonical MEgATrack reconstruction from
    :mod:`repro.core.handtracking`; custom workloads are hashable frozen
    dataclasses, so each distinct pair gets its own cached lowering.
    """
    detnet = detnet or build_detnet()
    keynet = keynet or build_keynet()
    det = workload_arrays(detnet)
    key = workload_arrays(keynet)
    names = tuple(TECH_NODES)
    nodes = [TECH_NODES[n] for n in names]

    wm_rows = []
    for node in nodes:
        wm_rows.append([_mem_fields(node.sram), _mem_fields(node.mram)])
    wm = np.asarray(wm_rows, np.float64)          # (n_nodes, 2, 4)

    n_cuts = det.n_layers + key.n_layers + 1
    pay_cam = np.zeros(n_cuts, np.float64)
    pay_det = np.zeros(n_cuts, np.float64)
    pay_key = np.zeros(n_cuts, np.float64)
    pay_max = np.zeros(n_cuts, np.float64)
    rate_acc = {RATE_CAMERA: pay_cam, RATE_DETNET: pay_det,
                RATE_KEYNET: pay_key}
    for cut in range(n_cuts):
        plan = mipi_payloads(cut, detnet, keynet)
        for nbytes, rate in plan:
            rate_acc[rate][cut] += nbytes
        pay_max[cut] = max(b for b, _ in plan)

    return ModelArrays(
        det=det, key=key, node_names=names,
        e_mac=np.asarray([n.e_mac for n in nodes], np.float64),
        f_clk=np.asarray([n.f_clk for n in nodes], np.float64),
        sram_e_read=np.asarray([n.sram.e_read for n in nodes], np.float64),
        sram_e_write=np.asarray([n.sram.e_write for n in nodes], np.float64),
        sram_leak_on=np.asarray([n.sram.leak_on for n in nodes], np.float64),
        sram_leak_ret=np.asarray([n.sram.leak_ret for n in nodes],
                                 np.float64),
        wm_e_read=wm[:, :, 0],
        wm_leak_on=wm[:, :, 2],
        wm_leak_ret=wm[:, :, 3],
        pay_cam_rate=pay_cam,
        pay_det_rate=pay_det,
        pay_key_rate=pay_key,
        pay_max=pay_max,
    )


# ---------------------------------------------------------------------------
# Stacked (multi-model) tables — the batched workload axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class StackedWorkloadArrays:
    """Ragged per-model layer tables padded into one dense leading axis.

    ``n_layers[m]`` is model ``m``'s true layer count; every 2-D table has
    shape ``(n_models, max_layers + 1)`` with the tail of shorter rows
    edge-padded (prefix sums repeat their final total, ``peak_suffix``
    repeats its trailing 0).  The kernel clips its gather indices to the
    per-model ``n_layers``, so padded entries are only ever read through
    the always-poisoned beyond-``n_cuts`` cut indices — see the padded-cut
    masking note in ``docs/equations.md``.
    """

    names: tuple[str, ...]
    n_layers: np.ndarray          # (M,) int32 — true (unpadded) layer counts
    input_bytes: np.ndarray       # (M,)
    output_bytes: np.ndarray      # (M,)
    c_macs: np.ndarray            # (M, Lmax+1) — and the rest of the
    c_weight_bytes: np.ndarray    # WorkloadArrays prefix-sum tables, padded
    c_weight_stream: np.ndarray
    c_act_traffic: np.ndarray
    c_cycles_sensor: np.ndarray
    c_cycles_agg: np.ndarray
    peak_prefix: np.ndarray
    peak_suffix: np.ndarray


_WL_TABLE_FIELDS = ("c_macs", "c_weight_bytes", "c_weight_stream",
                    "c_act_traffic", "c_cycles_sensor", "c_cycles_agg",
                    "peak_prefix", "peak_suffix")


def _stack_workloads(wls: tuple[WorkloadArrays, ...]) -> StackedWorkloadArrays:
    width = max(w.n_layers for w in wls) + 1
    tables = {}
    for f in _WL_TABLE_FIELDS:
        rows = []
        for w in wls:
            a = getattr(w, f)
            # Edge padding: prefix sums repeat their total, peak_suffix its
            # trailing 0 — any accidental read of a padded slot is a no-op.
            rows.append(np.pad(a, (0, width - a.size), mode="edge"))
        tables[f] = np.asarray(rows, np.float64)
    return StackedWorkloadArrays(
        names=tuple(w.name for w in wls),
        n_layers=np.asarray([w.n_layers for w in wls], np.int32),
        input_bytes=np.asarray([w.input_bytes for w in wls], np.float64),
        output_bytes=np.asarray([w.output_bytes for w in wls], np.float64),
        **tables,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class StackedModelArrays:
    """A batch of :class:`ModelArrays` as one extra leading ``model`` axis.

    The technology tables are shared (every model prices against the same
    ``TECH_NODES`` registry); everything workload-derived — the DetNet /
    KeyNet prefix-sum tables and the per-cut MIPI payload tables — gains a
    leading axis of size ``n_models``, padded to the widest model.
    ``n_cuts[m]`` is the per-model *valid-cut* bound: grid cut indices at
    or beyond it evaluate to NaN for model ``m`` (the padded-cut mask), so
    one compiled kernel can sweep architectures with ragged layer counts.
    """

    model_names: tuple[str, ...]
    det: StackedWorkloadArrays
    key: StackedWorkloadArrays
    n_cuts: np.ndarray            # (M,) int32 — per-model valid-cut counts
    node_names: tuple[str, ...]

    # Shared technology tables (same shapes/meaning as ModelArrays).
    e_mac: np.ndarray
    f_clk: np.ndarray
    sram_e_read: np.ndarray
    sram_e_write: np.ndarray
    sram_leak_on: np.ndarray
    sram_leak_ret: np.ndarray
    wm_e_read: np.ndarray
    wm_leak_on: np.ndarray
    wm_leak_ret: np.ndarray

    # Per-model, per-cut MIPI payload tables, shape (M, n_cuts_max),
    # zero-padded beyond each model's n_cuts (poisoned before use).
    pay_cam_rate: np.ndarray
    pay_det_rate: np.ndarray
    pay_key_rate: np.ndarray
    pay_max: np.ndarray

    @property
    def n_models(self) -> int:
        return len(self.model_names)

    @property
    def n_cuts_max(self) -> int:
        return int(self.n_cuts.max())

    def node_index(self, node: str | TechNode) -> int:
        name = node if isinstance(node, str) else node.name
        try:
            return self.node_names.index(name)
        except ValueError:
            raise KeyError(f"unknown tech node {name!r}; "
                           f"have {self.node_names}") from None


@functools.lru_cache(maxsize=16)
def stack_model_arrays(models: tuple) -> StackedModelArrays:
    """Stack already-lowered :class:`ModelArrays` along a new model axis."""
    if not models:
        raise ValueError("need at least one model to stack")
    first = models[0]
    for m in models[1:]:
        if m.node_names != first.node_names:
            raise ValueError("stacked models must share the tech-node "
                             "registry")
    names, seen = [], {}
    for m in models:
        base = f"{m.det.name}+{m.key.name}"
        seen[base] = seen.get(base, 0) + 1
        names.append(base if seen[base] == 1 else f"{base}#{seen[base]}")

    n_cuts = np.asarray([m.n_cuts for m in models], np.int32)
    width = int(n_cuts.max())

    def pay(field):
        return np.asarray([np.pad(getattr(m, field),
                                  (0, width - getattr(m, field).size))
                           for m in models], np.float64)

    return StackedModelArrays(
        model_names=tuple(names),
        det=_stack_workloads(tuple(m.det for m in models)),
        key=_stack_workloads(tuple(m.key for m in models)),
        n_cuts=n_cuts,
        node_names=first.node_names,
        e_mac=first.e_mac, f_clk=first.f_clk,
        sram_e_read=first.sram_e_read, sram_e_write=first.sram_e_write,
        sram_leak_on=first.sram_leak_on, sram_leak_ret=first.sram_leak_ret,
        wm_e_read=first.wm_e_read, wm_leak_on=first.wm_leak_on,
        wm_leak_ret=first.wm_leak_ret,
        pay_cam_rate=pay("pay_cam_rate"), pay_det_rate=pay("pay_det_rate"),
        pay_key_rate=pay("pay_key_rate"), pay_max=pay("pay_max"),
    )


def stacked_model_arrays(workloads=None) -> StackedModelArrays:
    """Lower a batch of workloads into one stacked, padded table set.

    ``workloads`` is a sequence whose entries are either ``(detnet,
    keynet)`` :class:`~repro.core.workloads.NNWorkload` pairs (``None``
    selects the canonical MEgATrack network) or already-lowered
    :class:`ModelArrays`.  The result powers the ``model`` grid axis of
    :func:`repro.core.sweep.evaluate_grid` and
    :func:`repro.core.stream.stream_grid` — one compiled kernel sweeps
    every architecture variant.  Ragged layer counts are fine: shorter
    models NaN out beyond their own cut range.
    """
    if workloads is None:
        entries: tuple = ((None, None),)
    else:
        entries = tuple(workloads)
        if not entries:
            raise ValueError("need at least one workload entry")
    models = []
    for e in entries:
        if isinstance(e, ModelArrays):
            models.append(e)
        else:
            det, key = e
            models.append(model_arrays(det, key))
    return stack_model_arrays(tuple(models))


# Link / camera scalars the kernel closes over (kept here so sweep.py has a
# single import site for every physical constant it consumes).
CAMERA_SENSE_W = DPS_CAMERA.sense
CAMERA_READ_W = DPS_CAMERA.read
CAMERA_IDLE_W = DPS_CAMERA.idle
T_SENSE = T_SENSE_S
MIPI_E_PER_BYTE = MIPI.energy_per_byte
MIPI_BW = MIPI.bandwidth
UTSV_E_PER_BYTE = UTSV.energy_per_byte
UTSV_BW = UTSV.bandwidth
FULL_FRAME = float(FULL_FRAME_BYTES)


# ---------------------------------------------------------------------------
# State carry-over and the device-resident table buffer (PyTorch port)
# ---------------------------------------------------------------------------


def tables_from_numpy(obj) -> StackedModelArrays:
    """Build this package's :class:`StackedModelArrays` from any object
    that carries the same fields (a stack lowered elsewhere, e.g. by
    the JAX reference package), field by field: nested ``det``/``key``
    workload stacks included, arrays copied as numpy with their dtypes,
    name tuples as tuples."""
    def convert(cls, src):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(src, f.name)
            if f.name in ("det", "key"):
                kw[f.name] = convert(StackedWorkloadArrays, v)
            elif isinstance(v, (tuple, list)):
                kw[f.name] = tuple(v)
            else:
                kw[f.name] = np.array(v)
        return cls(**kw)

    return convert(StackedModelArrays, obj)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceTables:
    """Every array field of a :class:`StackedModelArrays`, packed into one
    contiguous float64 device buffer (the counterpart of the reference
    kernel's ``_split_tables``: the kernels read the tables from this one
    buffer by offset, the plain PyTorch path through ``views``).

    ``index`` maps the dotted field name (``"det.c_macs"``, ``"f_clk"``)
    to ``(offset, shape)`` into ``buf``; ``meta`` is the same table as an
    int64 ``(n_fields, 3)`` tensor of ``(offset, rows, cols)`` (``cols``
    is 1 for a 1-D field), in the order of ``names``.  Integer fields
    (layer and cut counts) are stored as exact float64 values.
    """

    buf: "object"                    # torch.Tensor, (total,) float64
    meta: "object"                   # torch.Tensor, (n_fields, 3) int64
    names: tuple[str, ...]
    index: dict
    views: dict

    def __getitem__(self, name: str):
        return self.views[name]

    @property
    def device(self):
        return self.buf.device


def tables_to_device(S: StackedModelArrays, device) -> DeviceTables:
    """Pack ``S`` into one float64 buffer on ``device`` (built once per
    plan; it stays on the device for every chunk of the sweep)."""
    import torch

    leaves: list[tuple[str, np.ndarray]] = []

    def collect(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, np.ndarray):
                leaves.append((prefix + f.name, v))
            elif dataclasses.is_dataclass(v):
                collect(v, prefix + f.name + ".")

    collect(S, "")
    index, meta, parts, off = {}, [], [], 0
    for name, a in leaves:
        if a.ndim not in (1, 2):
            raise ValueError(f"table {name!r} has {a.ndim} dims; "
                             f"expected 1 or 2")
        index[name] = (off, a.shape)
        meta.append((off, a.shape[0], a.shape[1] if a.ndim == 2 else 1))
        parts.append(np.asarray(a, np.float64).ravel())
        off += a.size
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    views = {name: buf[o:o + int(np.prod(shp))].view(shp)
             for name, (o, shp) in index.items()}
    return DeviceTables(
        buf=buf, meta=torch.tensor(meta, dtype=torch.int64),
        names=tuple(index), index=index, views=views)
