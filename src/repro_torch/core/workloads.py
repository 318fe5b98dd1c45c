"""Neural-network workload descriptions for the semi-analytical model.

A workload is a list of :class:`LayerSpec` — exactly the granularity the paper
extracts from the GVSoC/DORY/NEMO toolchain: per-layer MAC counts, weight
footprints and activation traffic.  The analytical equations (Eqs. 7-11) only
ever consume these aggregate counts, so any network expressible this way can
be pushed through the model (including, via ``repro.core.tpu_energy``, the
compiled HLO of the assigned LM architectures).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Iterable, List, Sequence, Tuple


class LayerKind(enum.Enum):
    CONV = "conv"            # regular KxK convolution
    POINTWISE = "pointwise"  # 1x1 convolution
    DEPTHWISE = "depthwise"  # KxK depthwise convolution
    FC = "fc"                # fully connected / matmul


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Per-layer counts (all sizes in bytes, 8-bit weights/activations).

    The geometry fields (k/stride/cin/cout) make the table *executable*:
    ``repro.models.cnn`` builds a real JAX model from them and validates
    its traced MACs against these counts.
    """

    name: str
    kind: LayerKind
    macs: int
    weight_bytes: int
    in_act_bytes: int
    out_act_bytes: int
    # geometry (0 for fc layers)
    k: int = 0
    stride: int = 1
    cin: int = 0
    cout: int = 0

    @property
    def arithmetic_intensity_w(self) -> float:
        """MACs per weight byte — the x-axis of the paper's Fig. 4 roofline
        when performance is bounded by weight streaming."""
        return self.macs / max(self.weight_bytes, 1)


@dataclasses.dataclass(frozen=True)
class NNWorkload:
    """A whole network as seen by the energy model."""

    name: str
    layers: Tuple[LayerSpec, ...]
    input_bytes: int      # bytes entering the network (image / ROI / tokens)
    output_bytes: int     # bytes leaving the network (ROI coords, keypoints..)

    # The reductions below are consumed on every Eq. 7-11 evaluation; they
    # are memoized (the dataclass is frozen, so they can never go stale).
    @functools.cached_property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @functools.cached_property
    def total_weight_bytes(self) -> int:
        return sum(l.weight_bytes for l in self.layers)

    @functools.cached_property
    def peak_act_bytes(self) -> int:
        return max((max(l.in_act_bytes, l.out_act_bytes) for l in self.layers),
                   default=0)

    @functools.cached_property
    def total_act_traffic_bytes(self) -> int:
        """Total activation bytes read+written across the network."""
        return sum(l.in_act_bytes + l.out_act_bytes for l in self.layers)

    def scaled(self, factor: float, name: str | None = None) -> "NNWorkload":
        """Uniformly scale MAC/weight/activation counts (ablation knob)."""
        layers = tuple(
            dataclasses.replace(
                l,
                macs=int(l.macs * factor),
                weight_bytes=int(l.weight_bytes * factor),
                in_act_bytes=int(l.in_act_bytes * factor),
                out_act_bytes=int(l.out_act_bytes * factor),
            )
            for l in self.layers
        )
        return NNWorkload(name or f"{self.name}x{factor:g}", layers,
                          int(self.input_bytes * factor),
                          int(self.output_bytes * factor))


# ---------------------------------------------------------------------------
# Layer builders (8-bit weights and activations, stride-aware)
# ---------------------------------------------------------------------------


def conv2d(name: str, h: int, w: int, cin: int, cout: int, k: int = 3,
           stride: int = 1, kind: LayerKind = LayerKind.CONV) -> LayerSpec:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    if kind is LayerKind.DEPTHWISE:
        assert cin == cout, "depthwise requires cin == cout"
        macs = k * k * cin * ho * wo
        weights = k * k * cin
    else:
        macs = k * k * cin * cout * ho * wo
        weights = k * k * cin * cout
    return LayerSpec(
        name=name, kind=kind, macs=macs, weight_bytes=weights,
        in_act_bytes=h * w * cin, out_act_bytes=ho * wo * cout,
        k=k, stride=stride, cin=cin, cout=cout,
    )


def pointwise(name: str, h: int, w: int, cin: int, cout: int) -> LayerSpec:
    return conv2d(name, h, w, cin, cout, k=1, kind=LayerKind.POINTWISE)


def depthwise(name: str, h: int, w: int, c: int, k: int = 3,
              stride: int = 1) -> LayerSpec:
    return conv2d(name, h, w, c, c, k=k, stride=stride,
                  kind=LayerKind.DEPTHWISE)


def fc(name: str, nin: int, nout: int) -> LayerSpec:
    return LayerSpec(name=name, kind=LayerKind.FC, macs=nin * nout,
                     weight_bytes=nin * nout, in_act_bytes=nin,
                     out_act_bytes=nout)


def dw_separable(prefix: str, h: int, w: int, cin: int, cout: int,
                 stride: int = 1) -> List[LayerSpec]:
    """MobileNet-style depthwise-separable block: DW 3x3 + PW 1x1."""
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    return [
        depthwise(f"{prefix}.dw", h, w, cin, stride=stride),
        pointwise(f"{prefix}.pw", ho, wo, cin, cout),
    ]
