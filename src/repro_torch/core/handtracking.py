"""The AR/VR Hand-Tracking workload (MEgATrack [8]) as layer tables.

The paper deploys the MEgATrack two-stage pipeline: **DetNet** finds the hand
and produces a region of interest (ROI); **KeyNet** regresses 21 keypoints
from the ROI crop.  MEgATrack does not publish full layer tables, so the
networks below are representative mobile-CNN reconstructions at the published
input resolutions (DetNet: 320x240 monochrome downsample; KeyNet: 96x96 ROI
crop), mixing regular, depthwise and pointwise convolutions so that all three
RBE roofline regimes of the paper's Fig. 4 are exercised.

Magnitudes are in the range the paper implies (DetNet a few hundred MMAC —
"sufficiently computationally intensive to strain many current systems" at
4 cameras x 30 fps; KeyNet lighter, run per-frame on the small crop).
"""

from __future__ import annotations

import functools

from .constants import (BYTES_PER_PIXEL_RAW, DETNET_INPUT_H, DETNET_INPUT_W,
                        IMAGE_H, IMAGE_W, ROI_H, ROI_W)
from .workloads import (LayerSpec, NNWorkload, conv2d, dw_separable, fc,
                        pointwise)


@functools.lru_cache(maxsize=None)
def build_detnet() -> NNWorkload:
    """Hand detector over the downscaled 320x240 monochrome frame."""
    h, w = DETNET_INPUT_H, DETNET_INPUT_W  # 240 x 320
    layers: list[LayerSpec] = []
    layers.append(conv2d("stem", w, h, 1, 16, k=3, stride=2))        # 160x120
    w, h = w // 2, h // 2
    layers += dw_separable("b1", w, h, 16, 48, stride=2)             # 80x60
    w, h = w // 2, h // 2
    layers += dw_separable("b2", w, h, 48, 48)
    layers += dw_separable("b3", w, h, 48, 96, stride=2)             # 40x30
    w, h = w // 2, h // 2
    layers += dw_separable("b4", w, h, 96, 96)
    layers.append(conv2d("mid", w, h, 96, 96, k=3))
    layers += dw_separable("b5", w, h, 96, 192, stride=2)            # 20x15
    w, h = w // 2, (h + 1) // 2
    layers += dw_separable("b6", w, h, 192, 192)
    layers.append(conv2d("neck", w, h, 192, 192, k=3))
    layers.append(conv2d("neck2", w, h, 192, 192, k=3))
    # detection heads: box regression + palm confidence over anchor grid
    layers.append(pointwise("head.cls", w, h, 192, 6))
    layers.append(pointwise("head.box", w, h, 192, 24))
    return NNWorkload(
        name="DetNet",
        layers=tuple(layers),
        input_bytes=DETNET_INPUT_W * DETNET_INPUT_H,  # 1 B/px monochrome
        output_bytes=64,  # a handful of box candidates
    )


@functools.lru_cache(maxsize=None)
def build_keynet() -> NNWorkload:
    """Keypoint regressor over the 96x96 ROI crop."""
    h = w = ROI_H  # 96
    layers: list[LayerSpec] = []
    layers.append(conv2d("stem", w, h, 1, 32, k=3, stride=2))        # 48
    w = h = 48
    layers += dw_separable("b1", w, h, 32, 64, stride=2)             # 24
    w = h = 24
    layers += dw_separable("b2", w, h, 64, 64)
    layers += dw_separable("b3", w, h, 64, 128, stride=2)            # 12
    w = h = 12
    layers += dw_separable("b4", w, h, 128, 128)
    layers.append(conv2d("mid", w, h, 128, 128, k=3))
    layers += dw_separable("b5", w, h, 128, 256, stride=2)           # 6
    w = h = 6
    layers += dw_separable("b6", w, h, 256, 256)
    layers.append(fc("head.kp", 6 * 6 * 256, 21 * 3))  # 21 keypoints x 3
    return NNWorkload(
        name="KeyNet",
        layers=tuple(layers),
        input_bytes=ROI_W * ROI_H,
        output_bytes=21 * 3 * 2,  # 21 keypoints, 16-bit fixed point
    )


ROI_BYTES = ROI_W * ROI_H            # int8 crop shipped over MIPI in DOSC mode
# Raw 10-bit frame (RAW10-packed) shipped over MIPI (centralized) / uTSV (DOSC)
FULL_FRAME_BYTES = int(IMAGE_W * IMAGE_H * BYTES_PER_PIXEL_RAW)
