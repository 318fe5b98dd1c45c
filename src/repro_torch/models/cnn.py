"""The hand-tracking CNNs (DetNet / KeyNet) as runnable PyTorch models.

The port of the reference ``repro.models.cnn``.  The semi-analytical
model consumes these networks as layer *tables*
(:mod:`repro_torch.core.handtracking`); :class:`HandCNN` makes the same
networks executable, layer for layer, from the geometry recorded in each
:class:`~repro_torch.core.workloads.LayerSpec`.

Layouts: the model takes and returns NHWC, as the reference does, and
computes in NCHW inside.  Weights are OIHW for regular and pointwise
convolutions, ``(cin, 1, k, k)`` for depthwise ones and ``(in, out)`` for
the FC head; :func:`params_from_jax` carries the reference's HWIO /
``(k, k, 1, cin)`` / ``(in, out)`` arrays across.

Numerics, matching the reference's choices:

* "SAME" padding as XLA computes it: the total pad of each axis is
  ``max((out - 1) s + k - in, 0)``, its odd unit on the high side (every
  stride-2 layer of both nets pads (0, 1)).
* Float32 throughout, with TF32 off: cuDNN would otherwise convolve in
  TF32 on the card, while the reference convolves in full float32.
* ``use_rbe_int8=True`` routes exactly the layers the reference routes
  to its int8 kernel — 1x1 convolutions with ``cin`` and ``cout``
  multiples of 128 (KeyNet's ``b4.pw``, ``b5.pw``, ``b6.pw``) — through
  :func:`repro_torch.kernels.rbe_matmul.rbe_matmul` on the NHWC pixels.
  The FC head stays on the float path, as in the reference's code.
* Flattening (DetNet's heads, the FC input) is in NHWC order.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.handtracking import build_detnet, build_keynet
from repro_torch.core.sweep import resolve_device
from repro_torch.core.workloads import LayerKind, LayerSpec, NNWorkload
from repro_torch.kernels.rbe_matmul import rbe_matmul


@contextlib.contextmanager
def full_float32():
    """Convolutions and matmuls in IEEE float32 (TF32 off) for the body
    of the ``with``; every other cuDNN flag keeps its value."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = saved


def _nhwc_flat(y: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW activation in NHWC order: (B, H*W*C)."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad an NCHW tensor as XLA's "SAME" does (odd unit high)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def rbe_routed(spec: LayerSpec) -> bool:
    """Whether ``use_rbe_int8=True`` runs ``spec`` on the int8 kernel."""
    return (spec.kind is not LayerKind.FC and spec.k == 1
            and spec.cin % 128 == 0 and spec.cout % 128 == 0)


def params_from_jax(params: list[dict[str, np.ndarray]]
                    ) -> list[dict[str, torch.Tensor]]:
    """Carry the reference's parameters (``HandCNN.init``'s list of
    ``{"w", "b"}``) into this model's layout: HWIO conv weights become
    OIHW, depthwise ``(k, k, 1, cin)`` weights ``(cin, 1, k, k)`` (the
    same permutation), FC ``(in, out)`` weights and biases stay."""
    out = []
    for p in params:
        w = torch.as_tensor(np.asarray(p["w"]))
        if w.dim() == 4:
            w = w.permute(3, 2, 0, 1)
        out.append({"w": w.contiguous(),
                    "b": torch.as_tensor(np.asarray(p["b"])).clone()})
    return out


class HandCNN(nn.Module):
    """Executable twin of a hand-tracking layer table."""

    def __init__(self, workload: NNWorkload, input_hw: tuple[int, int],
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.workload = workload
        self.input_hw = tuple(input_hw)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        ws, bs = [], []
        for spec in workload.layers:
            if spec.kind is LayerKind.FC:
                shape = (spec.in_act_bytes, spec.out_act_bytes)
                scale, nb = spec.in_act_bytes ** -0.5, spec.out_act_bytes
            elif spec.kind is LayerKind.DEPTHWISE:
                shape = (spec.cin, 1, spec.k, spec.k)
                scale, nb = spec.k ** -1.0, spec.cin
            else:
                shape = (spec.cout, spec.cin, spec.k, spec.k)
                scale = (spec.k * spec.k * spec.cin) ** -0.5
                nb = spec.cout
            ws.append(nn.Parameter(
                torch.randn(shape, generator=generator) * scale,
                requires_grad=False))
            bs.append(nn.Parameter(torch.zeros(nb), requires_grad=False))
        self.weights = nn.ParameterList(ws)
        self.biases = nn.ParameterList(bs)
        self.to(resolve_device(device))

    @classmethod
    def detnet(cls, generator: torch.Generator | None = None,
               device="cuda") -> "HandCNN":
        return cls(build_detnet(), (240, 320), generator, device)

    @classmethod
    def keynet(cls, generator: torch.Generator | None = None,
               device="cuda") -> "HandCNN":
        return cls(build_keynet(), (96, 96), generator, device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def load_params(self, params: list[dict[str, torch.Tensor]]) -> None:
        """Copy ``params`` (this model's layout, e.g. from
        :func:`params_from_jax`) into the model, checking every shape."""
        if len(params) != len(self.weights):
            raise ValueError(f"expected {len(self.weights)} layers, "
                             f"got {len(params)}")
        for spec, p, w, b in zip(self.workload.layers, params, self.weights,
                                 self.biases):
            for name, dst in (("w", w), ("b", b)):
                src = torch.as_tensor(p[name])
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{spec.name}.{name}: shape "
                                     f"{tuple(src.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)

    def _conv(self, x, spec: LayerSpec, w, groups: int = 1):
        return F.conv2d(_same_pad(x, spec.k, spec.stride), w,
                        stride=spec.stride, groups=groups)

    @torch.no_grad()
    def forward(self, x_nhwc: torch.Tensor,
                use_rbe_int8: bool = False) -> torch.Tensor:
        """x: (B, H, W, 1).  Returns the head output (B, out).

        Layers named ``head.*`` are parallel heads over the trunk output
        (DetNet's cls/box heads); their outputs are flattened (NHWC) and
        concatenated.
        """
        x = x_nhwc.permute(0, 3, 1, 2)
        heads: list[torch.Tensor] = []
        trunk = None
        with full_float32():
            for spec, w, b in zip(self.workload.layers, self.weights,
                                  self.biases):
                if spec.kind is LayerKind.FC:
                    x = _nhwc_flat(x) @ w + b
                    continue
                if spec.name.startswith("head."):
                    if trunk is None:
                        trunk = x
                    y = self._conv(trunk, spec, w) + b[:, None, None]
                    heads.append(_nhwc_flat(y))
                    continue
                if spec.kind is LayerKind.DEPTHWISE:
                    y = self._conv(x, spec, w, groups=spec.cin)
                elif use_rbe_int8 and rbe_routed(spec):
                    bsz, c, h, wd = x.shape
                    pix = x.permute(0, 2, 3, 1).reshape(bsz * h * wd, c)
                    y = rbe_matmul(pix, w.reshape(spec.cout, c).t())
                    y = y.reshape(bsz, h, wd, spec.cout).permute(0, 3, 1, 2)
                else:
                    y = self._conv(x, spec, w)
                x = torch.relu(y + b[:, None, None])
        if heads:
            return torch.cat(heads, dim=-1)
        return x if x.dim() == 2 else x.permute(0, 2, 3, 1)

    def traced_macs(self, batch: int = 1) -> int:
        """MACs of the real traced model (validates the analytic table)."""
        total = 0
        area = self.input_hw[0] * self.input_hw[1]
        for spec in self.workload.layers:
            if spec.kind is LayerKind.FC:
                total += spec.in_act_bytes * spec.out_act_bytes
                continue
            area = math.ceil(area / (spec.stride * spec.stride)) \
                if spec.stride > 1 else area
            if spec.kind is LayerKind.DEPTHWISE:
                total += spec.k * spec.k * spec.cin * area
            else:
                total += spec.k * spec.k * spec.cin * spec.cout * area
        return total * batch

    def param_bytes(self) -> int:
        return self.workload.total_weight_bytes
