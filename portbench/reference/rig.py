"""The hand-tracking rig's tables, worked out from its published model.

A frozen copy of the rig's definition (arXiv:2203.07474, Eq. 1-11, and
the reference repo's ``core/constants.py``, ``core/handtracking.py``,
``core/workloads.py``, ``core/rbe.py`` and the table lowering of
``core/arrays.py``), in plain Python and NumPy.  The benchmark's
reference evaluates the rig from these tables; it never reads the tables
of the program under test.

:func:`rig_tables` returns every table the evaluation gathers from, as
float64 NumPy arrays keyed by name, and the scalar link and camera
constants as floats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Table 1 (camera), Table 2 (links), memories and nodes (calibrated values)
# ---------------------------------------------------------------------------

CAMERA_SENSE_W = 15e-3
CAMERA_READ_W = 36e-3
CAMERA_IDLE_W = 1.5e-3
T_SENSE = 4.8e-3 + 1.0e-3
UTSV_E_PER_BYTE, UTSV_BW = 5e-12, 100e9
MIPI_E_PER_BYTE, MIPI_BW = 100e-12, 0.5e9


@dataclasses.dataclass(frozen=True)
class Memory:
    e_read: float
    e_write: float
    leak_on: float
    leak_ret: float


SRAM_16NM = Memory(0.80e-12, 1.00e-12, 1.7701e-3 / (1 << 20),
                   0.4662e-3 / (1 << 20))
MRAM_16NM = Memory(1.20e-12, 10.0e-12, 0.0531e-3 / (1 << 20), 0.00)
SRAM_7NM = Memory(0.50e-12, 0.65e-12, 1.2986e-3 / (1 << 20),
                  0.3420e-3 / (1 << 20))


@dataclasses.dataclass(frozen=True)
class Node:
    e_mac: float
    f_clk: float
    sram: Memory
    mram: Optional[Memory]


#: Technology nodes, in table order (the order of the node tables).
NODES = {"16nm": Node(0.1635e-12, 500e6, SRAM_16NM, MRAM_16NM),
         "7nm": Node(0.109e-12, 700e6, SRAM_7NM, None)}
WEIGHT_MEMS = ("sram", "mram")

# RBE accelerator (133 MAC/cycle peak, 8 B/cycle weight port)
RBE_PEAK, RBE_PORT = 133.0, 8.0
RBE_UTIL = {"conv": 0.92, "pointwise": 0.55, "depthwise": 0.16, "fc": 0.50}
ON_SENSOR_SCALE = 0.25
SENSOR_L1_BYTES = 16 * 1024
AGG_L1_BYTES = 64 * 1024
L1_ENERGY_SCALE = 0.4
L1_TILE_BYTES = 48 * 1024

# MEgATrack system parameters
IMAGE_W, IMAGE_H = 640, 480
BYTES_PER_PIXEL_RAW = 1.25
DETNET_INPUT_W, DETNET_INPUT_H = 320, 240
ROI_W, ROI_H = 96, 96
BOX_COORDS_BYTES = 64
ROI_BYTES = ROI_W * ROI_H
FULL_FRAME = float(int(IMAGE_W * IMAGE_H * BYTES_PER_PIXEL_RAW))

# ---------------------------------------------------------------------------
# DetNet and KeyNet layer tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str
    macs: int
    weight_bytes: int
    in_act_bytes: int
    out_act_bytes: int


def conv2d(h, w, cin, cout, k=3, stride=1, kind="conv") -> Layer:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    if kind == "depthwise":
        macs, weights = k * k * cin * ho * wo, k * k * cin
    else:
        macs, weights = k * k * cin * cout * ho * wo, k * k * cin * cout
    return Layer(kind, macs, weights, h * w * cin, ho * wo * cout)


def pointwise(h, w, cin, cout) -> Layer:
    return conv2d(h, w, cin, cout, k=1, kind="pointwise")


def dw_separable(h, w, cin, cout, stride=1) -> list:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    return [conv2d(h, w, cin, cin, stride=stride, kind="depthwise"),
            pointwise(ho, wo, cin, cout)]


def fc(nin, nout) -> Layer:
    return Layer("fc", nin * nout, nin * nout, nin, nout)


def detnet() -> tuple[list, int, int]:
    """DetNet's layers, input bytes and output bytes."""
    h, w = DETNET_INPUT_H, DETNET_INPUT_W
    layers = [conv2d(w, h, 1, 16, k=3, stride=2)]
    w, h = w // 2, h // 2
    layers += dw_separable(w, h, 16, 48, stride=2)
    w, h = w // 2, h // 2
    layers += dw_separable(w, h, 48, 48)
    layers += dw_separable(w, h, 48, 96, stride=2)
    w, h = w // 2, h // 2
    layers += dw_separable(w, h, 96, 96)
    layers.append(conv2d(w, h, 96, 96, k=3))
    layers += dw_separable(w, h, 96, 192, stride=2)
    w, h = w // 2, (h + 1) // 2
    layers += dw_separable(w, h, 192, 192)
    layers.append(conv2d(w, h, 192, 192, k=3))
    layers.append(conv2d(w, h, 192, 192, k=3))
    layers.append(pointwise(w, h, 192, 6))
    layers.append(pointwise(w, h, 192, 24))
    return layers, DETNET_INPUT_W * DETNET_INPUT_H, 64


def keynet() -> tuple[list, int, int]:
    """KeyNet's layers, input bytes and output bytes."""
    h = w = ROI_H
    layers = [conv2d(w, h, 1, 32, k=3, stride=2)]
    w = h = 48
    layers += dw_separable(w, h, 32, 64, stride=2)
    w = h = 24
    layers += dw_separable(w, h, 64, 64)
    layers += dw_separable(w, h, 64, 128, stride=2)
    w = h = 12
    layers += dw_separable(w, h, 128, 128)
    layers.append(conv2d(w, h, 128, 128, k=3))
    layers += dw_separable(w, h, 128, 256, stride=2)
    w = h = 6
    layers += dw_separable(w, h, 256, 256)
    layers.append(fc(6 * 6 * 256, 21 * 3))
    return layers, ROI_W * ROI_H, 21 * 3 * 2


def _stream_bytes(l: Layer) -> int:
    return l.weight_bytes * max(1, math.ceil(l.out_act_bytes
                                            / L1_TILE_BYTES))


def _mac_per_cycle(l: Layer, scale: float) -> float:
    peak = RBE_PEAK * scale * RBE_UTIL[l.kind]
    intensity = l.macs / max(_stream_bytes(l), 1)
    return max(1e-9, min(peak, intensity * RBE_PORT * scale))


def _cumsum0(values) -> np.ndarray:
    return np.concatenate(([0.0], np.cumsum(np.asarray(values, np.float64))))


def _network_tables(prefix: str, net) -> dict:
    layers, in_bytes, out_bytes = net
    n = len(layers)
    peaks = [float(max(l.in_act_bytes, l.out_act_bytes)) for l in layers]
    pre, suf = np.zeros(n + 1), np.zeros(n + 1)
    for k in range(n):
        pre[k + 1] = max(pre[k], peaks[k])
        suf[n - 1 - k] = max(suf[n - k], peaks[n - 1 - k])
    t = {
        "n_layers": float(n), "input_bytes": float(in_bytes),
        "output_bytes": float(out_bytes),
        "c_macs": _cumsum0([float(l.macs) for l in layers]),
        "c_weight_bytes": _cumsum0([float(l.weight_bytes) for l in layers]),
        "c_weight_stream": _cumsum0([float(_stream_bytes(l))
                                     for l in layers]),
        "c_act_traffic": _cumsum0([float(l.in_act_bytes + l.out_act_bytes)
                                   for l in layers]),
        "c_cycles_sensor": _cumsum0([l.macs / _mac_per_cycle(
            l, ON_SENSOR_SCALE) for l in layers]),
        "c_cycles_agg": _cumsum0([l.macs / _mac_per_cycle(l, 1.0)
                                  for l in layers]),
        "peak_prefix": pre, "peak_suffix": suf,
    }
    return {f"{prefix}.{k}": v for k, v in t.items()}


def _payloads(cut: int, det, key) -> list:
    """What crosses MIPI at partition cut ``cut``: ``[(bytes, rate)]``."""
    n_det = len(det[0])
    if cut == 0:
        return [(FULL_FRAME, "camera")]
    if cut < n_det:
        return [(det[0][cut - 1].out_act_bytes, "detnet"),
                (BOX_COORDS_BYTES, "detnet"), (ROI_BYTES, "keynet")]
    if cut == n_det:
        return [(det[2], "detnet"), (ROI_BYTES, "keynet")]
    return [(key[0][cut - n_det - 1].out_act_bytes, "keynet"),
            (det[2], "detnet")]


def rig_tables() -> dict:
    """Every table of the rig: the networks' prefix sums
    (``det.*``, ``key.*``), the node and memory tables (rows in
    :data:`NODES` order; ``wm_*`` (node, weight memory), NaN where a node
    has no such memory) and the per-cut MIPI payloads (``pay_*``)."""
    det, key = detnet(), keynet()
    t = {**_network_tables("det", det), **_network_tables("key", key)}
    nodes = list(NODES.values())
    t["e_mac"] = np.array([n.e_mac for n in nodes])
    t["f_clk"] = np.array([n.f_clk for n in nodes])
    for f in ("e_read", "e_write", "leak_on", "leak_ret"):
        t[f"sram_{f}"] = np.array([getattr(n.sram, f) for n in nodes])
    for f in ("e_read", "leak_on", "leak_ret"):
        t[f"wm_{f}"] = np.array([[getattr(m, f) if m is not None else np.nan
                                  for m in (n.sram, n.mram)] for n in nodes])
    n_cuts = len(det[0]) + len(key[0]) + 1
    pay = {r: np.zeros(n_cuts) for r in ("camera", "detnet", "keynet")}
    pay_max = np.zeros(n_cuts)
    for cut in range(n_cuts):
        plan = _payloads(cut, det, key)
        for nbytes, rate in plan:
            pay[rate][cut] += nbytes
        pay_max[cut] = max(b for b, _ in plan)
    t["pay_cam_rate"], t["pay_det_rate"] = pay["camera"], pay["detnet"]
    t["pay_key_rate"], t["pay_max"] = pay["keynet"], pay_max
    return t


def n_cuts() -> int:
    """Partition cuts of the rig: every layer boundary, both ends."""
    return len(detnet()[0]) + len(keynet()[0]) + 1
