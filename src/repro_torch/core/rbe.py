"""RBE accelerator throughput model — reproduces the roofline of Fig. 4.

The paper observes (via GVSoC): "layer performance is almost completely
bounded by the weight streaming in the accelerator.  The RBE demonstrates
close to peak performance on full convolutional benchmarks, with diminishing
performance for pointwise kernels, and even further decrease when doing
depthwise kernels."

We model the effective throughput of layer *j* as a two-term roofline:

    (MAC/cycle)_j = min( util(kind_j) * PEAK,
                         AI_w(j) * weight_port_bytes_per_cycle )

where ``AI_w`` is the layer's MACs-per-weight-byte *as streamed* (weights are
re-fetched once per output tile, the DORY-style tiling determined by the L1
size), and ``util`` is the engine's structural efficiency for the layer kind
(depthwise layers cannot fill the input-channel parallelism of the engine).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

from .constants import RBE, RBESpec, TechNode
from .workloads import LayerKind, LayerSpec, NNWorkload

# L1 tile budget used by the DORY-style tiling: how many output activation
# bytes fit per tile before weights must be re-streamed.
L1_TILE_BYTES = 48 * 1024


def _util(kind: LayerKind, spec: RBESpec) -> float:
    return {
        LayerKind.CONV: spec.util_conv,
        LayerKind.POINTWISE: spec.util_pointwise,
        LayerKind.DEPTHWISE: spec.util_depthwise,
        LayerKind.FC: spec.util_fc,
    }[kind]


@functools.lru_cache(maxsize=65536)
def weight_stream_bytes(layer: LayerSpec,
                        l1_tile_bytes: int = L1_TILE_BYTES) -> int:
    """Total weight bytes streamed from L2-weight for one inference of the
    layer: weights are re-fetched once per output tile."""
    n_tiles = max(1, math.ceil(layer.out_act_bytes / l1_tile_bytes))
    return layer.weight_bytes * n_tiles


@functools.lru_cache(maxsize=4096)
def total_weight_stream_bytes(workload: NNWorkload,
                              l1_tile_bytes: int = L1_TILE_BYTES) -> int:
    """Streamed weight bytes for one inference of the whole network
    (the per-layer reduction Eq. 8 consumes on every evaluation)."""
    return sum(weight_stream_bytes(l, l1_tile_bytes)
               for l in workload.layers)


def streamed_intensity(layer: LayerSpec,
                       l1_tile_bytes: int = L1_TILE_BYTES) -> float:
    """MACs per *streamed* weight byte (x-axis of the Fig. 4 roofline)."""
    return layer.macs / max(weight_stream_bytes(layer, l1_tile_bytes), 1)


def mac_per_cycle(layer: LayerSpec, spec: RBESpec = RBE,
                  scale: float = 1.0,
                  l1_tile_bytes: int = L1_TILE_BYTES) -> float:
    """Effective MAC/cycle for a layer (Eq. 9's (MAC/cycle)_j term).

    ``scale`` shrinks the engine (the paper's on-sensor processor has 1/4 the
    aggregator's compute capability).
    """
    peak = spec.peak_mac_per_cycle * scale * _util(layer.kind, spec)
    bw_bound = streamed_intensity(layer, l1_tile_bytes) * \
        spec.weight_port_bytes_per_cycle * scale
    return max(1e-9, min(peak, bw_bound))


def processing_time_s(workload: NNWorkload, node: TechNode,
                      spec: RBESpec = RBE, scale: float = 1.0) -> float:
    """Eq. 9: T_processing = sum_j #MAC_j / (MAC/cycle)_j / f_clk."""
    cycles = sum(l.macs / mac_per_cycle(l, spec, scale)
                 for l in workload.layers)
    return cycles / node.f_clk


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    """One layer's position on the Fig. 4 roofline plot."""

    layer: str
    kind: str
    intensity_mac_per_byte: float   # streamed-weight arithmetic intensity
    mac_per_cycle: float
    peak_fraction: float
    bound: str                      # "compute" | "weight-stream"


def roofline_points(workload: NNWorkload, spec: RBESpec = RBE,
                    scale: float = 1.0) -> list[RooflinePoint]:
    pts = []
    for l in workload.layers:
        eff = mac_per_cycle(l, spec, scale)
        peak = spec.peak_mac_per_cycle * scale
        bw_bound = streamed_intensity(l) * spec.weight_port_bytes_per_cycle \
            * scale
        bound = "weight-stream" if bw_bound < peak * _util(l.kind, spec) \
            else "compute"
        pts.append(RooflinePoint(
            layer=l.name, kind=l.kind.value,
            intensity_mac_per_byte=streamed_intensity(l),
            mac_per_cycle=eff, peak_fraction=eff / peak, bound=bound,
        ))
    return pts
