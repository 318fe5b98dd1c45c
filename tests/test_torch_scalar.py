"""The port's scalar model (``energy``, ``system``, ``latency``) and
partition search (``partition``, ``sweep.evaluate_one``) against the
reference package, run in its child process.

The scalar model is the same Python float arithmetic on both sides, so
every value must be equal, not close.  ``optimal_partition`` finds its
winner on a grid engine (the reference's XLA, the port's plain PyTorch
on the CPU) and renders it through the scalar path, so the returned
``PartitionPoint``s must be equal too.  ``evaluate_one`` returns grid
channel values, held at 1e-12 relative: XLA on the CPU contracts
multiply-adds the port computes as two operations (ROADMAP, ground
rules).
"""

import json

import pytest

from _jax_reference import dataclasses_dict, point_summary, run
from repro_torch.core import latency, partition, sweep, system

SYSTEMS = {
    "cen_16nm": dict(agg_node="16nm"),
    "cen_knobs": dict(agg_node="7nm", num_cameras=2, detnet_fps=10.0,
                      keynet_fps=15.0, camera_fps=60.0),
    "dis_mram": dict(agg_node="7nm", sensor_node="16nm",
                     sensor_weight_mem="mram"),
    "dis_knobs": dict(agg_node="16nm", sensor_node="7nm", num_cameras=6,
                      detnet_fps=5.0, t_sense=0.002),
}

EVALUATE = {
    "default": {},
    "16nm_mram": dict(agg_node="16nm", sensor_node="16nm",
                      sensor_weight_mem="mram"),
    "knobs": dict(detnet_fps=5.0, keynet_fps=15.0, num_cameras=2,
                  mipi_energy_scale=2.0, camera_fps=60.0),
}

ONE = {"paper_split": (18, {}),
       "knobs": (25, dict(sensor_node="16nm", sensor_weight_mem="mram",
                          detnet_fps=10.0, num_cameras=2)),
       "centralized": (0, dict(agg_node="16nm", mipi_energy_scale=3.0))}

#: optimal_partition calls: every objective, scalar and sequence knobs,
#: constraints, both scalar-knob engines.
OPTIMAL = {}
for _obj in partition.OBJECTIVES:
    OPTIMAL[f"{_obj}"] = dict(objective=_obj)
    OPTIMAL[f"{_obj}-scalar"] = dict(objective=_obj, engine="scalar")
    OPTIMAL[f"{_obj}-16nm-mram"] = dict(objective=_obj, sensor_node="16nm",
                                        sensor_weight_mem="mram")
    OPTIMAL[f"{_obj}-seq"] = dict(objective=_obj,
                                  sensor_node=["7nm", "16nm"],
                                  detnet_fps=[5.0, 10.0, 30.0])
    OPTIMAL[f"{_obj}-cuts"] = dict(objective=_obj, cuts=list(range(5, 20)),
                                   keynet_fps=[15.0, 30.0])
OPTIMAL["power-latency-budget"] = dict(objective="avg_power",
                                       constraints={"latency": 0.0150})
OPTIMAL["power-latency-budget-scalar"] = dict(
    objective="avg_power", engine="scalar", constraints={"latency": 0.0150})
OPTIMAL["latency-mipi-cap-seq"] = dict(
    objective="latency", constraints=["mipi_bytes_per_s <= 2e6"],
    sensor_node=["7nm", "16nm"], num_cameras=[2, 4])
OPTIMAL["mipi-power-floor"] = dict(
    objective="mipi_bytes_per_s",
    constraints={"avg_power": (">=", 0.021)}, detnet_fps=[5.0, 15.0, 30.0])

#: Sequence-knob calls that take the streaming route once the threshold
#: is lowered to STREAM_AT configurations (each grid is 30-204).
STREAM_AT = 16
STREAMED = {name: kw for name, kw in OPTIMAL.items()
            if any(isinstance(v, list) for v in kw.values())}


def _json(obj):
    return json.loads(json.dumps(obj))


@pytest.fixture(scope="module")
def scalar_ref():
    return run("scalar", systems=SYSTEMS)


@pytest.fixture(scope="module")
def partition_ref():
    return run("partition", cuts=list(range(34)), evaluate=EVALUATE,
               sweeps={"default": {}, "knobs": EVALUATE["knobs"]},
               optimal=OPTIMAL, one=ONE)


@pytest.fixture(scope="module")
def stream_ref():
    return run("partition", threshold=STREAM_AT, optimal=STREAMED)


def _report(rep) -> dict:
    return point_summary(partition.PartitionPoint(
        cut=0, label="", avg_power=0.0, mipi_bytes_per_s=0.0,
        sensor_macs_per_s=0.0, latency=0.0, report=rep))["report"]


def test_pricing_and_figures_equal_reference(scalar_ref):
    from repro_torch import handtracking_pipeline as HP
    assert HP.pricing() == scalar_ref["pricing"]
    assert system.fig5a_comparison() == scalar_ref["fig5a"]
    assert system.fig5b_comparison() == scalar_ref["fig5b"]
    assert system.fig5b_comparison("16nm", 30.0) == scalar_ref["fig5b_16nm_30"]
    assert latency.latency_comparison(agg_node="16nm", detnet_every=1) \
        == scalar_ref["latency_16"]
    assert [dataclasses_dict(latency.cut_latency(c))
            for c in range(0, 34, 3)] == scalar_ref["cut_latency"]


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_system_reports_equal_reference(scalar_ref, name):
    builder = (system.build_centralized if name.startswith("cen")
               else system.build_distributed)
    assert _report(builder(**SYSTEMS[name])) == scalar_ref[name]


@pytest.mark.parametrize("name", sorted(EVALUATE))
def test_evaluate_cut_equals_reference(partition_ref, name):
    got = [point_summary(partition.evaluate_cut(c, **EVALUATE[name]))
           for c in range(34)]
    assert got == partition_ref["cuts"][name]


@pytest.mark.parametrize("name", ["default", "knobs"])
def test_sweep_partitions_equals_reference(partition_ref, name):
    kw = {} if name == "default" else dict(EVALUATE["knobs"])
    got = [point_summary(p) for p in partition.sweep_partitions(**kw)]
    assert got == partition_ref["sweeps"][name]


@pytest.mark.parametrize("name", sorted(ONE))
def test_evaluate_one_matches_reference(partition_ref, name):
    cut, kw = ONE[name]
    got = sweep.evaluate_one(cut, device="cpu", **kw)
    want = partition_ref["one"][name]
    assert got.keys() == want.keys()
    for f in want:
        assert got[f] == pytest.approx(want[f], rel=1e-12, abs=0), f


@pytest.mark.parametrize("name", sorted(OPTIMAL))
def test_optimal_partition_equals_reference(partition_ref, name):
    got = partition.optimal_partition(device="cpu", **_json(OPTIMAL[name]))
    assert point_summary(got) == partition_ref["optimal"][name]


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_optimal_partition_stream_route(stream_ref, partition_ref,
                                        monkeypatch, name):
    """With the threshold lowered in both processes the sequence-knob
    searches stream; they find the dense route's point."""
    from repro_torch.core import stream
    calls = []
    real = stream.stream_grid
    monkeypatch.setattr(stream, "stream_grid",
                        lambda **kw: calls.append(kw) or real(**kw))
    monkeypatch.setattr(partition, "STREAM_THRESHOLD", STREAM_AT)
    got = partition.optimal_partition(device="cpu", **_json(STREAMED[name]))
    assert len(calls) == 1
    assert point_summary(got) == stream_ref["optimal"][name]
    assert point_summary(got) == partition_ref["optimal"][name]


def test_evaluate_one_rejects_sequences():
    with pytest.raises(ValueError, match="scalar knobs only"):
        sweep.evaluate_one(3, device="cpu", detnet_fps=(5.0, 10.0))


def test_scalar_axes_maps_kwargs():
    axes = sweep.scalar_axes(dict(agg_node="16nm", detnet_fps=[5.0, 10.0],
                                  sensor_weight_mem=None))
    assert axes["agg_nodes"] == ("16nm",)
    assert axes["detnet_fps"] == (5.0, 10.0)
    assert axes["weight_mems"] == ("sram",)
    assert axes["detnet"] is None and axes["keynet"] is None


@pytest.mark.parametrize("kw, match", [
    pytest.param(dict(scenarios="default"),
                 "unknown scenario profile 'default'",
                 id="kw0-scenario-engine slice"),
    pytest.param(dict(objective="time_to_empty_s"),
                 "is a session channel; pass scenarios=",
                 id="kw3-session channel"),
])
def test_unported_options_raise(kw, match):
    """scenarios= is ported: an unknown profile and a session objective
    without scenarios= raise the reference's ValueError."""
    with pytest.raises(ValueError, match=match):
        partition.optimal_partition(device="cpu", **kw)


@pytest.mark.parametrize("kw, exc, match", [
    (dict(objective="energy"), ValueError, "unknown objective"),
    (dict(backend="xla"), ValueError, "unknown evaluation backend"),
    (dict(engine="scalar", backend="torch"), ValueError, "engine='scalar'"),
    (dict(detnet_fsp=5.0), TypeError, "unknown knobs"),
    (dict(sensor_node="7nm", sensor_weight_mem="mram"), ValueError,
     "no MRAM test vehicle"),
    (dict(engine="scalar", cuts=(1, 2)), ValueError, "engine='array'"),
    (dict(constraints={"latency": 1e-9}), ValueError, "no configuration"),
])
def test_optimal_partition_validation(kw, exc, match):
    with pytest.raises(exc, match=match):
        partition.optimal_partition(device="cpu", **kw)


def test_optimal_partition_backends_agree():
    a = partition.optimal_partition(device="cpu", backend="torch",
                                    sensor_node=("7nm", "16nm"))
    b = partition.optimal_partition(device="cpu", sensor_node=("7nm", "16nm"))
    assert point_summary(a) == point_summary(b)
