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

``ANCHOR_1M`` holds what the reference's dense ``evaluate_grid``
returns over the 1,000,960-config grid, just under
``partition.STREAM_THRESHOLD`` (so ``optimal_partition`` evaluates it
densely), as :func:`dense_summary` reads it: copied from a run of the
JAX package on the CPU and re-derived by ``tests/test_torch_anchors.py``.

``SCENARIO_REF_GRID`` and ``SCENARIO_BIG_GRID`` are the reference's
scenario benchmark grids (``benchmarks/scenario_bench.py``: ``REF_GRID``,
36 configs x 4 traces, and ``BIG_GRID``, 34 cuts x 2 sensor nodes x 2
weight memories x 26 DetNet rates x 72 camera rates = 254,592 configs x
4 traces = 1,018,368 (config x trace) pairs, 20 session steps each).
``ANCHOR_SCENARIO_1M`` holds what the reference's ``stream_grid(
scenarios="all", objectives=SCENARIO_OBJECTIVES, maximize=(
"time_to_empty_s",), **SCENARIO_BIG_GRID)`` returns, as
:func:`scenario_summary` reads it: copied from a run of the JAX package
on the CPU (through the ``enable_x64`` shim of
``tests/_jax_reference.py``: ``run("scenario", streams=...)``; 7.9 s
there) and re-derived from it by ``tests/test_torch_scenario.py``.

``OPTIMIZE_SEARCH`` is the reference's own knob search
(``examples/partition_study.py::knob_search``): the weighted objective
``{"avg_power": 1, "latency": 10}`` over ``detnet_fps`` 5-30 and
``camera_fps`` 20-60 at cut 18 (every DetNet layer on the sensor, the
16nm sensor node), 200 projected-Adam steps, and the 41 x 41 grid.
``ANCHOR_OPTIMIZE`` holds what the reference's ``repro.core.optimize``
returns there: ``gradient`` at the default knobs, ``optimize_knobs``'s
knobs, objective and trajectory, and ``grid_argmin``; copied from a run
of the JAX package on the CPU (``run("optimize", ...)`` of
``tests/_jax_reference.py``) and re-derived from it by
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
    (97,920 / 1,000,960 / 10,009,600 / 100,096,000 for n = 10^5 / 10^6 /
    10^7 / 10^8; the reference stream benchmark's ``_grid_for``)."""
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
    elif n >= 100_000:
        g["camera_fps"] = tuple(np.linspace(20.0, 60.0, 9))
    return g


def index_hash(indices) -> str:
    """sha256 of a flat-index set (sorted, int64 bytes)."""
    a = np.sort(np.asarray(indices, np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()


#: The objectives of the anchors' top-k rows and fronts (the default
#: objectives of ``pareto.pareto_front`` and ``stream.stream_grid``).
ANCHOR_OBJECTIVES = ("avg_power", "latency", "mipi_bytes_per_s")


def top_k_flat(values, k: int = 4) -> tuple:
    """Flat indices of the ``k`` lowest finite values, ties by index
    (``SweepResult.top_k``'s order), NaN never."""
    v = np.asarray(values, np.float64).ravel()
    v = np.where(np.isnan(v), np.inf, v)
    order = np.lexsort((np.arange(v.size), v))[:k]
    return tuple(int(i) for i in order if np.isfinite(v[i]))


def dense_summary(data, front_indices) -> dict:
    """What ``ANCHOR_1M`` freezes, from a dense result's channels
    (``{field: array}``, C order) and the flat indices of its Pareto
    front over :data:`ANCHOR_OBJECTIVES`: the size, each field's first
    minimum (NaN ignored), the best ``avg_power``, the top-4 of each
    objective, the finite ``avg_power`` count and the front's size and
    :func:`index_hash`."""
    flat = {f: np.asarray(v, np.float64).ravel() for f, v in data.items()}
    power = flat["avg_power"]
    return dict(
        n_configs=power.size,
        argmin_idx={f: int(np.nanargmin(v)) for f, v in flat.items()},
        best_avg_power=float(np.nanmin(power)),
        topk_idx=tuple(top_k_flat(flat[o]) for o in ANCHOR_OBJECTIVES),
        finite=int(np.isfinite(power).sum()),
        front_size=int(np.asarray(front_indices).size),
        front_hash=index_hash(front_indices),
    )


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

ANCHOR_1M = dict(
    n_configs=1_000_960,
    argmin_idx={"avg_power": 982_560, "camera": 29_440, "utsv": 0,
                "mipi": 971_520, "sensor_compute": 0, "sensor_memory": 0,
                "agg_compute": 971_520, "agg_memory": 971_520,
                "mipi_bytes_per_s": 971_520, "sensor_macs_per_s": 0,
                "latency": 58_971},
    best_avg_power=0.007680588538256027,
    topk_idx=((982560, 997280, 982652, 997372),
              (58971, 59063, 59339, 59431),
              (971520, 971521, 971522, 971523)),
    finite=758_080,
    front_size=784,
    front_hash="1502a2d7ecb0e12b83a79b633e259c91"
               "a568aea8affec2dcd86d4fd2cbae2cfc",
)

#: The reference scenario benchmark's grids (``REF_GRID``, ``BIG_GRID``)
#: and objectives; every sweep of them runs ``scenarios="all"``.
SCENARIO_REF_GRID = dict(
    cuts=(0, 11, 20),
    sensor_nodes=("7nm", "16nm"),
    weight_mems=("sram", "mram"),
    detnet_fps=(5.0, 15.0, 30.0),
)
SCENARIO_BIG_GRID = dict(
    sensor_nodes=("7nm", "16nm"),
    weight_mems=("sram", "mram"),
    detnet_fps=tuple(np.linspace(5.0, 30.0, 26)),
    camera_fps=tuple(np.linspace(20.0, 60.0, 72)),
)
SCENARIO_OBJECTIVES = ("time_to_empty_s", "peak_case_temp_c")


def scenario_summary(res) -> dict:
    """What ``ANCHOR_SCENARIO_1M`` freezes, from a ``StreamResult`` of
    :data:`SCENARIO_OBJECTIVES` with ``time_to_empty_s`` maximized: the
    size, the best (largest) time-to-empty and the smallest peak case
    temperature with their flat indices and traces, the top-4 of each
    objective, the finite counts and the front's flat indices."""
    best = res.top_k("time_to_empty_s")[0]
    cool = res.argmin("peak_case_temp_c")
    return dict(
        n_pairs=res.n_configs,
        best_tte=float(res.topk_val[0][0]),
        best_tte_idx=int(res.topk_idx[0][0]),
        best_tte_trace=best["trace"],
        min_peak=float(res.min_val["peak_case_temp_c"]),
        min_peak_idx=int(res.min_idx["peak_case_temp_c"]),
        min_peak_trace=cool["trace"],
        topk_idx=tuple(tuple(int(i) for i in row) for row in res.topk_idx),
        finite=int(res.finite_counts["time_to_empty_s"]),
        front_idx=tuple(sorted(int(i) for i in res.front_indices)),
    )


ANCHOR_SCENARIO_1M = dict(
    n_pairs=1_018_368,
    best_tte=1130028.8246170545,
    best_tte_idx=1_010_882,
    best_tte_trace="workday",
    min_peak=25.197729423587923,
    min_peak_idx=1_010_882,
    min_peak_trace="workday",
    topk_idx=((1010882, 1010886, 1011170, 1010890),
              (1010882, 1010886, 1011170, 1010890)),
    finite=771_264,
    front_idx=(1_010_882,),
)

OPTIMIZE_SEARCH = dict(
    objective={"avg_power": 1.0, "latency": 10.0},
    bounds={"detnet_fps": (5.0, 30.0), "camera_fps": (20.0, 60.0)},
    config=dict(cut=18, sensor_node="16nm"),
    steps=200,
    n=41,
)

#: The search reaches the box corner (DetNet at 5 fps, the camera at 60)
#: at step 12 and stays there: the trajectory is its first 13 values,
#: then the optimum to the end.
_OPT_BEST = 0.13647645291292973
ANCHOR_OPTIMIZE = dict(
    gradient_value=0.19659150768587508,
    gradient={"detnet_fps": 0.009443142326788745,
              "keynet_fps": 2.5466362898777594e-05,
              "mipi_energy_scale": 0.000110848,
              "camera_fps": -0.0026841421785335547},
    knobs={"detnet_fps": 5.0, "camera_fps": 60.0},
    objective=_OPT_BEST,
    trajectory=(0.2311813030435378, 0.21760580187408327,
                0.2053096776210636, 0.19413436545583576,
                0.18393996996970416, 0.17460267216059117,
                0.16601247511207556, 0.1580712290052028,
                0.15069090084118708, 0.14379207310000022,
                0.13730261221259196, 0.13651243489134693)
    + (_OPT_BEST,) * 189,
    grid_knobs={"detnet_fps": 5.0, "camera_fps": 60.0},
    grid_value=_OPT_BEST,
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
