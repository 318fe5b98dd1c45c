"""The paper's workload end to end on the port: DetNet -> ROI -> KeyNet.

    python -m repro_torch.handtracking_pipeline [--device cpu] [--batch N]

The counterpart of the reference's ``examples/handtracking_pipeline.py``,
for a batch of camera frames at once: DetNet on the frames, a 96x96 ROI
crop around each frame's max-confidence anchor, KeyNet on the crops on
the float32 path and on the RBE int8 path (the on-sensor engine's 8-bit
datapath, KeyNet's 128-aligned pointwise convolutions on the int8 kernel
of :mod:`repro_torch.kernels.rbe_matmul`), their relative error, and
the semi-analytical pricing of the pipeline.  Runs on the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import latency, system
from repro_torch.core.sweep import resolve_device
from repro_torch.models.cnn import HandCNN

FRAME_HW = (240, 320)
ROI = 96
#: DetNet's anchor grid as the reference example reads it (see
#: :func:`roi_origins`) and the pixels an anchor cell spans.
ANCHORS = (20, 15)
CELL = 16


def roi_origins(det_out: torch.Tensor) -> list[tuple[int, int]]:
    """The top-left corner ``(y0, x0)`` of each frame's ROI, from the
    max-confidence anchor of DetNet's output.

    Reproduces the reference example exactly: it reads the NHWC
    ``(15, 20, 6)`` class block as ``(20, 15, 6)`` and takes the row
    from the second index, so the crop is the one the reference takes.
    Ties go to the first maximum, as with ``jnp.argmax``."""
    n_cls = ANCHORS[0] * ANCHORS[1] * 6
    conf = det_out[:, :n_cls].reshape(-1, *ANCHORS, 6)[..., 0]
    best = torch.argmax(conf.reshape(conf.shape[0], -1), dim=1).tolist()
    out = []
    for flat in best:
        i0, i1 = divmod(flat, ANCHORS[1])
        cy, cx = i1 * CELL, i0 * CELL
        out.append((max(0, min(FRAME_HW[0] - ROI, cy - ROI // 2)),
                    max(0, min(FRAME_HW[1] - ROI, cx - ROI // 2))))
    return out


def crop_rois(frames: torch.Tensor, origins) -> torch.Tensor:
    """The ``ROI`` x ``ROI`` crops at ``origins``: (B, 96, 96, 1)."""
    return torch.stack([frames[i, y0:y0 + ROI, x0:x0 + ROI]
                        for i, (y0, x0) in enumerate(origins)])


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> list[float]:
    """Per-row relative L2 error of ``got`` against ``ref``."""
    num = torch.linalg.vector_norm(ref - got, dim=-1)
    den = torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-9)
    return (num / den).tolist()


def pricing() -> dict:
    """The example's pricing lines: both topologies' average power at
    7 nm (W) and the latency comparison."""
    return {"centralized_avg_power":
            system.build_centralized("7nm").avg_power,
            "distributed_avg_power":
            system.build_distributed("7nm", "7nm").avg_power,
            "latency": latency.latency_comparison()}


def pipeline_forward(frames: torch.Tensor, det: HandCNN,
                     key: HandCNN) -> dict:
    """One batch through both nets: DetNet, the ROIs, KeyNet float and
    KeyNet int8.  ``frames`` (B, 240, 320, 1) on the models' device."""
    det_out = det(frames)
    origins = roi_origins(det_out)
    rois = crop_rois(frames, origins)
    kp_f32 = key(rois)
    kp_int8 = key(rois, use_rbe_int8=True)
    return {"det_out": det_out, "origins": origins, "rois": rois,
            "kp_f32": kp_f32, "kp_int8": kp_int8,
            "rel_err": rel_err(kp_f32, kp_int8)}


def run_pipeline(frames, det_params, key_params, device="cuda") -> dict:
    """The pipeline on ``frames`` (B, 240, 320, 1) float32 with the given
    parameters (each net's list of ``{"w", "b"}`` in the port's layout,
    e.g. :func:`repro_torch.models.cnn.params_from_jax`), on ``device``.
    Returns :func:`pipeline_forward`'s dict plus ``"pricing"``."""
    dev = resolve_device(device)
    det = HandCNN.detnet(device=dev)
    det.load_params(det_params)
    key = HandCNN.keynet(device=dev)
    key.load_params(key_params)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    out = pipeline_forward(frames, det, key)
    out["pricing"] = pricing()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    frames = np.random.default_rng(args.seed).random(
        (args.batch, *FRAME_HW, 1), dtype=np.float32)
    det = HandCNN.detnet(torch.Generator().manual_seed(args.seed), dev)
    key = HandCNN.keynet(torch.Generator().manual_seed(args.seed + 1), dev)
    t0 = time.perf_counter()
    out = pipeline_forward(torch.as_tensor(frames, device=dev), det, key)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"DetNet: {tuple(out['det_out'].shape)} "
          f"({det.workload.total_macs / 1e6:.0f} MMAC analytic == "
          f"{det.traced_macs() / 1e6:.0f} MMAC traced a frame)")
    for i, ((y0, x0), err) in enumerate(zip(out["origins"],
                                            out["rel_err"])):
        print(f"frame {i}: ROI at ({y0},{x0}) — {ROI * ROI} B over MIPI "
              f"vs {FRAME_HW[0] * FRAME_HW[1]} B raw; KeyNet "
              f"{out['kp_f32'].shape[1] // 3} keypoints, int8-RBE path "
              f"rel err {err:.3%}")
    print(f"{args.batch} frame(s) on {dev}: {wall * 1e3:.1f} ms wall "
          f"(first call, set-up included)")

    price = pricing()
    cen, dis = price["centralized_avg_power"], price["distributed_avg_power"]
    lat = price["latency"]
    print("\nSemi-analytical pricing of this exact pipeline:")
    print(f"  power : centralized {cen * 1e3:.2f} mW vs "
          f"distributed {dis * 1e3:.2f} mW "
          f"(-{(1 - dis / cen) * 100:.1f}%)")
    print(f"  latency: centralized {lat['centralized_ms']:.2f} ms vs "
          f"distributed {lat['distributed_ms']:.2f} ms "
          f"(queue saving {lat['_queue_saving_ms']:.2f} ms, "
          f"readout saving {lat['_readout_saving_ms']:.2f} ms)")


if __name__ == "__main__":
    main()
