"""End-to-end frame latency for the two topologies (paper §1: the DOSC
system claims "significant benefits in terms of communication costs,
latency constraints and privacy").

Latency of one hand-tracking result, per camera frame, for an N-camera
rig.  The key structural difference:

* **centralized** — the aggregator serializes ALL cameras' work
  (N x (DetNet_amortized + KeyNet)) behind each result, and the raw frame
  crosses the slow MIPI first;
* **distributed** — DetNet runs *in parallel* on the N sensors (each at
  1/4 the aggregator's throughput), only the ROI crosses MIPI, and the
  aggregator's queue holds KeyNets only.

Uses the same Eq. 6 / Eq. 9 building blocks as the power model — one more
consumer of the semi-analytical counts.

Two granularities live here:

* :func:`centralized_latency` / :func:`distributed_latency` — the paper's
  two named topologies, with an integer ``detnet_every`` ROI-reuse knob.
* :func:`cut_latency` — the *generalized* per-cut model for any partition
  index over the concatenated DetNet ++ KeyNet layer list, parameterized by
  the same fps knobs as the power model.  This is the scalar reference for
  the vectorized ``latency`` channel of
  :func:`repro.core.sweep.evaluate_grid` (the cycle prefix-sums of
  :mod:`repro.core.arrays` are its lowering); ``tests/test_sweep.py`` pins
  the two to ≤1e-6 relative parity.
"""

from __future__ import annotations

import dataclasses

from . import energy as E
from . import rbe
from .arrays import RATE_DETNET, RATE_KEYNET, mipi_payloads
from .constants import (CAMERA_FPS, DETNET_FPS, KEYNET_FPS, MIPI,
                        NUM_CAMERAS, ON_SENSOR_SCALE, RBE, T_SENSE_S,
                        TECH_NODES, UTSV, TechNode)
from .handtracking import (FULL_FRAME_BYTES, ROI_BYTES, build_detnet,
                           build_keynet)
from .workloads import NNWorkload


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    name: str
    t_expose: float
    t_readout: float
    t_detnet: float        # amortized per frame (ROI reuse), own camera
    t_comm_roi: float
    t_queue: float         # other cameras' work serialized ahead of us
    t_keynet: float

    @property
    def total(self) -> float:
        return (self.t_expose + self.t_readout + self.t_detnet
                + self.t_comm_roi + self.t_queue + self.t_keynet)


def _node(x) -> TechNode:
    return TECH_NODES[x] if isinstance(x, str) else x


def centralized_latency(agg_node: str | TechNode = "7nm",
                        detnet_every: int = 3,
                        num_cameras: int = NUM_CAMERAS
                        ) -> LatencyBreakdown:
    node = _node(agg_node)
    det, key = build_detnet(), build_keynet()
    t_det = rbe.processing_time_s(det, node) / detnet_every
    t_key = rbe.processing_time_s(key, node)
    return LatencyBreakdown(
        name=f"centralized[A={node.name}]",
        t_expose=T_SENSE_S,
        t_readout=E.comm_time(FULL_FRAME_BYTES, MIPI),
        t_detnet=t_det,
        t_comm_roi=0.0,     # crop is local to the aggregator
        t_queue=(num_cameras - 1) * (t_det + t_key),
        t_keynet=t_key,
    )


def distributed_latency(agg_node: str | TechNode = "7nm",
                        sensor_node: str | TechNode = "7nm",
                        detnet_every: int = 3,
                        num_cameras: int = NUM_CAMERAS
                        ) -> LatencyBreakdown:
    agg, sen = _node(agg_node), _node(sensor_node)
    det, key = build_detnet(), build_keynet()
    t_key = rbe.processing_time_s(key, agg)
    return LatencyBreakdown(
        name=f"distributed[A={agg.name},O={sen.name}]",
        t_expose=T_SENSE_S,
        t_readout=E.comm_time(FULL_FRAME_BYTES, UTSV),
        t_detnet=rbe.processing_time_s(det, sen, scale=ON_SENSOR_SCALE)
        / detnet_every,     # parallel per sensor: no cross-camera queue
        t_comm_roi=E.comm_time(ROI_BYTES, MIPI),
        t_queue=(num_cameras - 1) * t_key,   # aggregator runs KeyNet only
        t_keynet=t_key,
    )


@dataclasses.dataclass(frozen=True)
class CutLatency:
    """Per-result latency decomposition for one partition cut.

    All times are seconds on the critical path of one hand-tracking result.
    ``t_detnet`` / ``t_comm_mipi`` are amortized by the ROI-reuse ratio
    ``min(1, detnet_fps / camera_fps)`` — DetNet work (and the payloads it
    produces) only lands on the critical path when DetNet actually runs.
    """

    cut: int
    t_expose: float
    t_readout: float       # full frame over the camera-side link (Eq. 6)
    t_detnet: float        # sensor prefix + aggregator suffix, amortized
    t_comm_mipi: float     # cut payloads over MIPI (DetNet-rate amortized)
    t_queue: float         # other cameras' aggregator work ahead of us
    t_keynet: float        # sensor prefix + aggregator suffix

    @property
    def total(self) -> float:
        return (self.t_expose + self.t_readout + self.t_detnet
                + self.t_comm_mipi + self.t_queue + self.t_keynet)


def _cycles(layers, scale: float) -> float:
    """Eq. 9 cycle count for a span of layers at one engine scale."""
    return sum(l.macs / rbe.mac_per_cycle(l, RBE, scale) for l in layers)


def cut_latency(cut: int,
                agg_node: str | TechNode = "7nm",
                sensor_node: str | TechNode = "7nm",
                detnet: NNWorkload | None = None,
                keynet: NNWorkload | None = None,
                num_cameras: int = NUM_CAMERAS,
                camera_fps: float = CAMERA_FPS,
                detnet_fps: float = DETNET_FPS,
                keynet_fps: float = KEYNET_FPS) -> CutLatency:
    """End-to-end result latency for an arbitrary partition cut.

    Generalizes :func:`centralized_latency` (``cut == 0``) and
    :func:`distributed_latency` (``cut == len(DetNet)``) to every layer
    boundary, with the integer ``detnet_every`` knob replaced by the
    continuous amortization ratio ``min(1, detnet_fps / camera_fps)``.  At
    ``cut == 0`` it reduces *exactly* to the centralized helper (for
    ``detnet_every == camera_fps / detnet_fps``); at the paper's split it
    additionally counts the tiny amortized DetNet-output payload that the
    topology-specific helper ignores.

    This is the scalar reference implementation of the grid engine's
    ``latency`` channel; both consume the payload plan of
    :func:`repro.core.arrays.mipi_payloads`.
    """
    agg, sen = _node(agg_node), _node(sensor_node)
    det = detnet or build_detnet()
    key = keynet or build_keynet()
    n_det = len(det.layers)
    n_all = n_det + len(key.layers)
    if not 0 <= cut <= n_all:
        raise ValueError(f"cut {cut} outside [0, {n_all}]")
    cd = min(cut, n_det)               # DetNet layers on-sensor
    ck = max(0, cut - n_det)           # KeyNet layers on-sensor
    amort = min(1.0, detnet_fps / camera_fps)

    t_det_sen = _cycles(det.layers[:cd], ON_SENSOR_SCALE) / sen.f_clk * amort
    t_det_agg = _cycles(det.layers[cd:], 1.0) / agg.f_clk * amort
    t_key_sen = _cycles(key.layers[:ck], ON_SENSOR_SCALE) / sen.f_clk
    t_key_agg = _cycles(key.layers[ck:], 1.0) / agg.f_clk

    # Cut payloads crossing MIPI on the critical path.  Camera-rate payloads
    # (the centralized raw frame) ARE the readout and are counted there.
    pay = {RATE_DETNET: 0.0, RATE_KEYNET: 0.0}
    for nbytes, tag in mipi_payloads(cut, det, key):
        if tag in pay:
            pay[tag] += nbytes
    t_comm = (pay[RATE_DETNET] * amort + pay[RATE_KEYNET]) / MIPI.bandwidth

    return CutLatency(
        cut=cut,
        t_expose=T_SENSE_S,
        t_readout=E.comm_time(FULL_FRAME_BYTES, UTSV if cut > 0 else MIPI),
        t_detnet=t_det_sen + t_det_agg,
        t_comm_mipi=t_comm,
        t_queue=(num_cameras - 1) * (t_det_agg + t_key_agg),
        t_keynet=t_key_sen + t_key_agg,
    )


def latency_comparison(**kw) -> dict[str, float]:
    c = centralized_latency(**kw)
    d = distributed_latency(**kw)
    return {
        "centralized_ms": c.total * 1e3,
        "distributed_ms": d.total * 1e3,
        "_saving": 1.0 - d.total / c.total,
        "_readout_saving_ms": (c.t_readout - d.t_readout) * 1e3,
        "_queue_saving_ms": (c.t_queue - d.t_queue) * 1e3,
    }
