"""Reference grids of the design-space engine and the parity anchors
frozen from the JAX reference package.

``REFERENCE_GRID`` is the 10,880-config grid every parity test runs
(34 cuts x 2 x 2 x 2 x 5 x 2 x 2 x 2).  :func:`stream_grid_axes` widens
it along the rate axes to the sizes the streaming benchmark sweeps
(``benchmarks/stream_bench.py::_grid_for`` of the reference: 1,000,960,
10,009,600 and 100,096,000 configs).

``ANCHOR_10M`` holds what the reference ``stream_grid`` returns over the
10,009,600-config grid with its default arguments (objectives
``avg_power``, ``latency``, ``mipi_bytes_per_s``; top-4): data, copied
from a run of the JAX package on the CPU, and re-derived from it by
``tests/test_torch_anchors.py``.

``PRICING_ANCHOR`` holds the reference's pricing of the hand-tracking
pipeline (``examples/handtracking_pipeline.py``): the average power of
``build_centralized("7nm")`` and ``build_distributed("7nm", "7nm")`` in
watts and ``latency_comparison()``, copied and re-derived the same way.
"""

from __future__ import annotations

import hashlib

import numpy as np

REFERENCE_GRID = dict(
    agg_nodes=("7nm", "16nm"),
    sensor_nodes=("7nm", "16nm"),
    weight_mems=("sram", "mram"),
    detnet_fps=(5.0, 10.0, 15.0, 20.0, 30.0),
    keynet_fps=(15.0, 30.0),
    num_cameras=(2, 4),
    mipi_energy_scale=(1.0, 2.0),
)


def stream_grid_axes(n: int) -> dict:
    """The reference grid widened along the rate axes to ~``n`` configs
    (1,000,960 / 10,009,600 / 100,096,000 for n = 10^6 / 10^7 / 10^8)."""
    g = dict(REFERENCE_GRID)
    if n >= 100_000_000:
        g["detnet_fps"] = tuple(np.linspace(5.0, 30.0, 50))
        g["keynet_fps"] = tuple(np.linspace(15.0, 30.0, 20))
        g["camera_fps"] = tuple(np.linspace(20.0, 60.0, 92))
    elif n >= 10_000_000:
        g["detnet_fps"] = tuple(np.linspace(5.0, 30.0, 50))
        g["camera_fps"] = tuple(np.linspace(20.0, 60.0, 92))
    elif n >= 1_000_000:
        g["camera_fps"] = tuple(np.linspace(20.0, 60.0, 92))
    return g


def index_hash(indices) -> str:
    """sha256 of a flat-index set (sorted, int64 bytes)."""
    a = np.sort(np.asarray(indices, np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()


ANCHOR_10M = dict(
    n_configs=10_009_600,
    argmin_idx=9_825_600,
    best_avg_power=0.007680588538256027,
    topk_idx=((9825600, 9972800, 9825692, 9972892),
              (588891, 588983, 589259, 589351),
              (9715200, 9715201, 9715202, 9715203)),
    finite=7_580_800,
    front_size=784,
    front_hash="8c441ebb46c2f302a055a8109e5c43bd"
               "8090bbaa37885da28ff560650b5f4af9",
)

PRICING_ANCHOR = dict(
    centralized_avg_power=0.027553258618113446,
    distributed_avg_power=0.02094809012529072,
    latency={"centralized_ms": 15.508995154854953,
             "distributed_ms": 14.763267154854951,
             "_saving": 0.048083579403695786,
             "_readout_saving_ms": 0.7641600000000001,
             "_queue_saving_ms": 4.830328729786069},
)
