"""The port's scenario engine (``repro_torch.core.scenario``) on the CPU.

Four ways, as the reference's ``tests/test_scenario.py`` pins its own
(that file restated here against the port, since it imports the
reference in process), plus the JAX reference itself, run in a child
process (``tests/_jax_reference.py``):

* closed-form oracles: the exact RC step response and the linear /
  Peukert battery drain admit analytic solutions for constant traces;
* bitwise parity: the batched session evaluation against the loop of
  ``simulate_session`` (multiphase, and with the throttle engaged), and
  a constant trace against the static ``evaluate_grid``;
* engine parity: the stream's argmin / top-k(maximize) / Pareto front /
  constraints over the session channels equal the dense grid's, for
  chunk sizes 256 and 4096 and scan fusion K 1 and 2;
* the reference: every channel of ``evaluate_grid(scenarios=...)`` on
  the reference scenario grid within 1e-12 relative with the same NaN
  pattern, the same argmin, top-k and front index sets, the stream's
  deliverables, ``simulate_session``'s trajectories, the partition
  search, the error messages and the job signature;
* properties: monotonicity and re-segmentation invariance, as
  deterministic cases and (when ``hypothesis`` is installed) as
  generated ones.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, point_summary, run
from repro_torch.core import backend as B
from repro_torch.core import pareto, partition, scenario as SC, stream, sweep
from repro_torch.core.constants import DEFAULT_BATTERY, DEFAULT_THERMAL
from repro_torch.core.grids import (SCENARIO_OBJECTIVES, SCENARIO_REF_GRID,
                                    top_k_flat)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    def given(*_a, **_k):
        return pytest.mark.skip(reason="hypothesis not installed")

    def settings(*_a, **_k):
        return lambda f: f

    class _StrategyStub:
        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _StrategyStub()

CPU = dict(device="cpu")
RTOL = 1e-6            # the oracles' tolerance (closed forms vs steps)
OBJ = SCENARIO_OBJECTIVES
MAX = ["time_to_empty_s"]
TTE_TEMP = {"peak_case_temp_c": ["<=", 25.4]}   # binds on the grid

#: Scenario sets of the parity cases, as JSON specs both packages build
#: (``_jax_reference.scenario_set``).
SETS = {
    "all": "all",
    "throttled": {"traces": ["gaming", "commute"],
                  "thermal": {"throttle_onset_c": 25.05,
                              "throttle_gain_per_c": 2.0}},
    "peukert": {"traces": ["commute", "steady"],
                "battery": {"name": "pk", "peukert": 1.2, "p_ref_w": 1.0}},
    "tiny_battery": {"traces": ["workday", ["const", [[600.0, 1, 1, 1, 1]]]],
                     "battery": {"name": "tiny", "capacity_j": 1.0},
                     "steps_per_phase": 3, "throttle": False},
}


def sset_of(spec):
    from _jax_reference import scenario_set
    return scenario_set(SC, spec)


def _single(duration_s=600.0, **kw):
    """A one-trace ScenarioSet around a single constant full-rate phase."""
    tr = SC.ScenarioTrace("const", (SC.Phase(float(duration_s)),))
    return SC.ScenarioSet(traces=(tr,), throttle=False, **kw)


def _small_grid(sset, **kw):
    kw.setdefault("cuts", (0, 11))
    kw.setdefault("detnet_fps", (5.0, 30.0))
    return sweep.evaluate_grid(scenarios=sset, **kw, **CPU)


def _rel(a, b):
    return abs(a - b) <= 1e-12 * abs(b)


# ---------------------------------------------------------------------------
# The JAX reference, one child process for the module
# ---------------------------------------------------------------------------

STREAMS = {
    "c256": (SCENARIO_REF_GRID, "all",
             dict(objectives=OBJ, maximize=MAX, chunk_size=256, top_k=5)),
    "constrained": (SCENARIO_REF_GRID, "all",
                    dict(objectives=OBJ, maximize=MAX, chunk_size=64,
                         constraints=TTE_TEMP, track="all")),
    "throttled": (SCENARIO_REF_GRID, SETS["throttled"],
                  dict(objectives=("throttle_fraction", "session_energy_j"),
                       chunk_size=32, hist_bins=8)),
}
SIMS = {
    "commute": ("commute", dict(cut=11, detnet_fps=10.0)),
    "throttled": ({"traces": ["gaming"],
                   "thermal": {"throttle_onset_c": 25.05,
                               "throttle_gain_per_c": 2.0}},
                  dict(cut=11, detnet_fps=30.0)),
    "tiny_battery": (SETS["tiny_battery"], dict(cut=20, sensor_node="16nm",
                                                trace="const")),
}
SIGNATURES = {
    "all": (SCENARIO_REF_GRID, "all",
            dict(objectives=OBJ, maximize=MAX, chunk_size=256)),
    "custom": (SCENARIO_REF_GRID, SETS["tiny_battery"],
               dict(objectives=OBJ, constraints=TTE_TEMP, top_k=3)),
    "plain": (SCENARIO_REF_GRID, None, dict(track="all")),
}
PKW = dict(sensor_node=["7nm", "16nm"], detnet_fps=[5.0, 15.0, 30.0])
OPTIMAL = {
    "tte_under_temp": ("all", dict(objective="time_to_empty_s",
                                   constraints={"peak_case_temp_c":
                                                ["<=", 40.0]}, **PKW), None),
    "tte_tight": ("all", dict(objective="time_to_empty_s",
                              constraints=TTE_TEMP, **PKW), None),
    "tte_dense": ("all", dict(objective="time_to_empty_s", **PKW), None),
    "tte_stream": ("all", dict(objective="time_to_empty_s", **PKW), 8),
    "peak_stream": ("all", dict(objective="peak_case_temp_c", **PKW), 8),
    "static_steady": ("steady", dict(objective="avg_power"), None),
    "plain": (None, dict(objective="avg_power"), None),
}
SINGLE = {"traces": [["const", [[60.0, 1, 1, 1, 1]]]], "throttle": False}
ERRORS = {
    "stream_session_objective": ("stream_grid", [], dict(
        objectives=["time_to_empty_s"], detnet_fps=[5.0])),
    "constraint_channels": ("parse_constraints", [{"bogus": 1.0}], {}),
    "kernel_backend": ("evaluate_grid", [], dict(
        cuts=[0], scenarios=SINGLE, backend="pallas")),
    "partition_needs_scenarios": ("optimal_partition", [], dict(
        objective="time_to_empty_s")),
    "partition_unknown_objective": ("optimal_partition", [], dict(
        objective="bogus")),
    "unknown_profile": ("as_scenario_set", ["afk"], {}),
    "unknown_trace": ("only", ["afk", "all"], {}),
    "bad_entry": ("as_scenario_set", [[3]], {}),
    "scalar_engine": ("optimal_partition", [], dict(
        engine="scalar", scenarios="steady")),
}
#: The port's side of each error call (backends by their port names).
PORT_CALLS = {
    "evaluate_grid": lambda **kw: sweep.evaluate_grid(**kw, **CPU),
    "stream_grid": lambda **kw: stream.stream_grid(**kw, **CPU),
    "optimal_partition": lambda **kw: partition.optimal_partition(**kw,
                                                                  **CPU),
    "parse_constraints": sweep.parse_constraints,
    "as_scenario_set": SC.as_scenario_set,
    "only": lambda name, spec: sset_of(spec).only(name),
}
TO_PORT = {v: k for k, v in B.SIGNATURE_BACKEND.items()}


@pytest.fixture(scope="module")
def ref():
    dense = {name: (SCENARIO_REF_GRID, spec,
                    {"obj": (OBJ, MAX),
                     "static": (pareto.DEFAULT_OBJECTIVES, [])})
             for name, spec in SETS.items()}
    return run("scenario", dense=dense, streams=STREAMS, sims=SIMS,
               signatures=SIGNATURES, optimal=OPTIMAL, errors=ERRORS)


@pytest.fixture(scope="module")
def dense():
    return {name: sweep.evaluate_grid(scenarios=sset_of(spec),
                                      **SCENARIO_REF_GRID, **CPU)
            for name, spec in SETS.items()}


# ---------------------------------------------------------------------------
# Against the JAX reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SETS))
def test_every_channel_matches_reference(ref, dense, name):
    """Every static and session channel within 1e-12 relative, the NaN
    pattern (and infinities) identical, the trace labels equal."""
    want, got = ref["dense"][name], dense[name]
    assert got.shape == tuple(want["shape"])
    assert got.axes["trace"] == tuple(want["trace"])
    assert tuple(got.data) == sweep.FIELDS + sweep.SCENARIO_FIELDS
    assert set(got.data) == set(want["data"])
    for f, v in want["data"].items():
        assert_close(got.data[f].ravel(), v, what=f"{name} {f}")


@pytest.mark.parametrize("name", list(SETS))
def test_index_sets_match_reference(ref, dense, name):
    """argmin of every channel, top-4 of each scenario objective (time to
    empty maximized) and both Pareto fronts: the same flat indices."""
    want, got = ref["dense"][name], dense[name]
    for f, v in want["data"].items():
        if not np.isnan(v).all():
            assert np.nanargmin(got.data[f]) == np.nanargmin(v), f
    tte, peak = want["data"]["time_to_empty_s"], want["data"][
        "peak_case_temp_c"]
    assert top_k_flat(-got.data["time_to_empty_s"]) == top_k_flat(-tte)
    assert top_k_flat(got.data["peak_case_temp_c"]) == top_k_flat(peak)
    for fname, (objs, maxi) in (("obj", (OBJ, MAX)),
                                ("static", (pareto.DEFAULT_OBJECTIVES, []))):
        front = pareto.pareto_front(got, objectives=objs, maximize=maxi)
        assert np.array_equal(np.sort(front.indices),
                              np.sort(want["fronts"][fname])), fname


def test_throttle_engages_on_the_throttled_set(dense):
    """Every valid configuration of the throttled set spends part of its
    sessions throttled, for how long depends on the configuration."""
    tf = dense["throttled"].data["throttle_fraction"]
    assert np.nanmin(tf) > 0.0 and np.nanmax(tf) > np.nanmin(tf)


def _summary_close(got: dict, want: dict, what: str):
    assert got["min_idx"] == want["min_idx"], what
    assert got["finite"] == want["finite"], what
    for f in want["min_val"]:
        assert_close(got["min_val"][f], want["min_val"][f], what=f)
        assert_close(got["bounds"][f], want["bounds"][f], what=f)
    assert np.array_equal(got["topk_idx"], want["topk_idx"]), what
    assert_close(got["topk_val"], want["topk_val"], what=what)
    assert np.array_equal(np.sort(got["front_idx"]),
                          np.sort(want["front_idx"])), what
    if want["hist"] is not None:
        for f, h in want["hist"].items():
            assert np.array_equal(got["hist"][f], h), f


def port_summary(res) -> dict:
    return {"min_idx": dict(res.min_idx), "min_val": dict(res.min_val),
            "finite": dict(res.finite_counts),
            "bounds": {f: (res.channel_min[f], res.channel_max[f])
                       for f in res.min_val},
            "topk_idx": res.topk_idx, "topk_val": res.topk_val,
            "front_idx": res.front_indices,
            "hist": ({f: h for f, (h, _) in res.hist.items()}
                     if res.hist else None)}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_reference(ref, name):
    grid, spec, kw = STREAMS[name]
    res = stream.stream_grid(scenarios=sset_of(spec), **grid, **kw, **CPU)
    assert res.backend == "torch"
    _summary_close(port_summary(res), ref["streams"][name], name)
    # the wire format: the reference's keys, the trace labels as axis
    # values, and a round trip that keeps them
    got = stream.result_to_json(res)
    want = ref["streams"][name]["json"]
    assert set(got) == set(want)
    assert got["axes"] == want["axes"]
    back = stream.result_from_json(got)
    assert back.axes["trace"] == res.axes["trace"]
    for o in res.objectives:
        assert [p["trace"] for p in back.top_k(o)] == [
            p["trace"] for p in res.top_k(o)]


@pytest.mark.parametrize("name", list(SIMS))
def test_simulate_session_matches_reference(ref, name):
    spec, kw = SIMS[name]
    got = SC.simulate_session(scenarios=sset_of(spec), **kw, **CPU)
    want = ref["sims"][name]
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close(np.asarray(got[k], np.float64),
                     np.asarray(v, np.float64), what=k)


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_job_signature_equals_reference(ref, name):
    """The content hash of a (scenario) stream job is the reference's
    digest, so each package resumes the other's checkpoints."""
    grid, spec, kw = SIGNATURES[name]
    plan = stream.plan_stream(scenarios=sset_of(spec), **grid, **kw, **CPU)
    assert plan.signature == ref["signatures"][name]


def test_signature_tracks_the_scenario_content():
    grid, spec, kw = SIGNATURES["all"]
    base = stream.plan_stream(scenarios="all", **grid, **kw, **CPU)
    hot = dataclasses.replace(SC.as_scenario_set("all"),
                              thermal=dataclasses.replace(
                                  DEFAULT_THERMAL, ambient_c=30.0))
    other = stream.plan_stream(scenarios=hot, **grid, **kw, **CPU)
    again = stream.plan_stream(scenarios="all", **grid, **kw, **CPU)
    assert base.signature == again.signature != other.signature


@pytest.mark.parametrize("name", list(OPTIMAL))
def test_optimal_partition_matches_reference(ref, monkeypatch, name):
    spec, kw, threshold = OPTIMAL[name]
    if threshold is not None:
        monkeypatch.setattr(partition, "STREAM_THRESHOLD", threshold)
    got = point_summary(partition.optimal_partition(
        scenarios=sset_of(spec), **kw, **CPU))
    want = ref["optimal"][name]
    session, want_session = got.pop("session"), want.pop("session")
    assert got == want
    if want_session is None:
        assert session is None and got["trace"] is None
    else:
        assert set(session) == set(sweep.SCENARIO_FIELDS)
        for f, v in want_session.items():
            assert _rel(session[f], v), (f, session[f], v)


@pytest.mark.parametrize("name", list(ERRORS))
def test_error_messages_match_reference(ref, name):
    """The port raises the reference's exception and message (backend
    names mapped to their port counterparts: ``pallas`` -> ``cuda``,
    ``xla`` -> ``torch``; the module path ``repro_torch`` for
    ``repro``)."""
    fn, args, kw = ERRORS[name]
    want = ref["errors"][name]
    kw = dict(kw)
    if "backend" in kw:
        kw["backend"] = TO_PORT[kw["backend"]]
    if isinstance(kw.get("scenarios"), dict):
        kw["scenarios"] = sset_of(kw["scenarios"])
    if want is None:
        PORT_CALLS[fn](*args, **kw)
        return
    etype, msg = want
    for theirs, ours in B.SIGNATURE_BACKEND.items():
        msg = msg.replace(f"'{ours}'", f"'{theirs}'")
    msg = msg.replace("repro.core", "repro_torch.core")
    with pytest.raises(Exception) as ei:
        PORT_CALLS[fn](*args, **kw)
    assert type(ei.value).__name__ == etype
    assert str(ei.value).strip("\"'") == msg.strip("\"'")


def test_cuda_backend_refuses_scenarios_and_default_runs_torch():
    with pytest.raises(ValueError, match="does not support scenario "
                                         "sweeps.*capable backends: "
                                         r"\('torch',\)"):
        sweep.evaluate_grid(cuts=(0,), scenarios=_single(60.0),
                            backend="cuda", **CPU)
    with pytest.raises(ValueError, match="does not support scenario"):
        stream.stream_grid(cuts=(0,), scenarios="steady", backend="cuda",
                           **CPU)
    with pytest.raises(ValueError, match="does not support scenario"):
        partition.optimal_partition(scenarios="steady", backend="cuda",
                                    **CPU)
    assert B.default_backend("cuda", scenarios=True) == "torch"
    assert B.get_backend(None, "cuda", scenarios=True).name == "torch"
    assert B.default_backend("cuda") == "cuda"
    plan = stream.plan_stream(cuts=(0, 1), scenarios="steady", **CPU)
    assert plan.backend == "torch"


# ---------------------------------------------------------------------------
# Closed-form oracles
# ---------------------------------------------------------------------------


class TestClosedFormOracles:
    """Constant-trace sessions against their analytic solutions."""

    def test_thermal_step_matches_exponential(self):
        """N exact RC substeps compose to the continuous solution."""
        th = DEFAULT_THERMAL
        tau = th.r_th_k_per_w * th.c_th_j_per_k
        P, D = 0.15, 600.0
        temp = torch.tensor(th.ambient_c, dtype=torch.float64)
        for _ in range(16):
            temp = SC.thermal_step(temp, torch.tensor(P, dtype=torch.float64),
                                   torch.tensor(D / 16, dtype=torch.float64),
                                   th)
        ref = th.ambient_c + P * th.r_th_k_per_w * (1.0 - math.exp(-D / tau))
        assert float(temp) == pytest.approx(ref, rel=1e-12)

    def test_peak_temp_closed_form(self):
        D = 600.0
        r = _small_grid(_single(D))
        th = DEFAULT_THERMAL
        tau = th.r_th_k_per_w * th.c_th_j_per_k
        P = r.data["avg_power"][..., 0]
        ref = th.ambient_c + P * th.r_th_k_per_w * (1.0 - np.exp(-D / tau))
        np.testing.assert_allclose(r.data["peak_case_temp_c"][..., 0], ref,
                                   rtol=RTOL)

    def test_battery_linear_drain_is_bitwise(self):
        """peukert == 1.0 -> exponent exactly 0.0 -> drain == power."""
        assert DEFAULT_BATTERY.peukert == 1.0
        for p in (0.019, 0.37, 2.5):
            t = torch.tensor([p], dtype=torch.float64)
            assert float(SC.effective_drain_w(t, DEFAULT_BATTERY)) == p

    @pytest.mark.parametrize("capacity_j", [1.0, DEFAULT_BATTERY.capacity_j],
                             ids=["crossing", "extrapolated"])
    def test_time_to_empty_linear_oracle_both_regimes(self, capacity_j):
        bat = dataclasses.replace(DEFAULT_BATTERY, name=f"c{capacity_j}",
                                  capacity_j=capacity_j)
        r = _small_grid(_single(600.0, battery=bat))
        P = r.data["avg_power"][..., 0]
        got = r.data["time_to_empty_s"][..., 0]
        np.testing.assert_allclose(got, bat.soc0 * capacity_j / P,
                                   rtol=RTOL)
        if capacity_j == 1.0:
            assert (got < 600.0).all()
        else:
            assert (got > 600.0).all()

    def test_time_to_empty_peukert_oracle(self):
        bat = dataclasses.replace(DEFAULT_BATTERY, name="pk", peukert=1.2,
                                  p_ref_w=1.0)
        r = _small_grid(_single(600.0, battery=bat))
        P = r.data["avg_power"][..., 0]
        np.testing.assert_allclose(r.data["time_to_empty_s"][..., 0],
                                   bat.soc0 * bat.capacity_j / P ** 1.2,
                                   rtol=RTOL)

    def test_session_energy_oracle(self):
        D = 600.0
        r = _small_grid(_single(D))
        np.testing.assert_allclose(r.data["session_energy_j"][..., 0],
                                   r.data["avg_power"][..., 0] * D,
                                   rtol=RTOL)

    def test_idle_battery_never_empties(self):
        """Zero drain -> time_to_empty_s == +inf (the sentinel survives
        the poisoning arithmetic); a tiny but nonzero drain is finite."""
        sset = _single(60.0)
        r = sweep.evaluate_grid(cuts=(0,), detnet_fps=(1e-12,),
                                keynet_fps=(1e-12,), camera_fps=(1e-12,),
                                scenarios=sset, **CPU)
        like = torch.zeros(1, dtype=torch.float64)
        carry = SC._init_carry(sset, like)
        carry = (torch.full_like(like, 60.0),) + carry[1:]
        out = SC._finalize(carry, torch.zeros_like(like), sset.battery)
        assert float(out["time_to_empty_s"]) == np.inf
        out = SC._finalize(carry, torch.full_like(like, np.nan),
                           sset.battery)
        assert all(math.isnan(float(v)) for v in out.values())
        assert np.isfinite(r.data["time_to_empty_s"]).all()


# ---------------------------------------------------------------------------
# Loop twin vs batched evaluation, constant-trace degeneracy
# ---------------------------------------------------------------------------


class TestScanLoopParity:
    """The batched session evaluation vs the loop of simulate_session:
    one step function, so bitwise."""

    def _check(self, sset, **cfg):
        sim = SC.simulate_session(scenarios=sset, **cfg, **CPU)
        r = sweep.evaluate_grid(cuts=(cfg.get("cut", 0),),
                                detnet_fps=(cfg.get("detnet_fps", 10.0),),
                                scenarios=sset, **CPU)
        for f in sweep.SCENARIO_FIELDS:
            assert sim[f] == float(r.data[f].ravel()[0]), f
        return sim

    def test_bitwise_parity_multiphase(self):
        sset = SC.ScenarioSet(traces=(SC.PROFILES["commute"],))
        self._check(sset, cut=11, detnet_fps=10.0)

    def test_bitwise_parity_with_throttle_active(self):
        th = dataclasses.replace(DEFAULT_THERMAL, throttle_onset_c=25.05,
                                 throttle_gain_per_c=2.0)
        sset = SC.ScenarioSet(traces=(SC.PROFILES["gaming"],), thermal=th)
        sim = self._check(sset, cut=11, detnet_fps=30.0)
        assert sim["throttle_fraction"] > 0.0     # feedback really engaged
        assert min(sim["throttle"]) < 1.0

    def test_trajectory_arrays_consistent(self):
        sim = SC.simulate_session(scenarios="commute", cut=11, **CPU)
        n = len(sim["t_s"])
        assert len(sim["soc"]) == len(sim["temp_c"]) == n
        assert (np.diff(sim["soc"]) <= 0).all()
        assert sim["energy_j"][-1] == sim["session_energy_j"]

    def test_padding_steps_are_bitwise_no_ops(self):
        """A trace shorter than its set's longest pads with zero-duration
        steps; its channels equal those of the trace run alone."""
        pair = SC.as_scenario_set(("steady", "workday"))
        alone = SC.as_scenario_set("steady")
        a = sweep.evaluate_grid(cuts=(0, 20), scenarios=pair, **CPU)
        b = sweep.evaluate_grid(cuts=(0, 20), scenarios=alone, **CPU)
        assert a.shape[-1] == 2 and pair.traces[0].phases != \
            pair.traces[1].phases
        for f in a.data:
            assert np.array_equal(a.data[f][..., 0], b.data[f][..., 0],
                                  equal_nan=True), f
        sim = SC.simulate_session(scenarios=pair, trace="steady", **CPU)
        assert len(sim["t_s"]) == 5       # steady alone: 4 steps
        # in the pair's table: padding after steady's four steps
        tabs = SC._step_tables(pair)
        assert (tabs[0][0, 4:] == 0.0).all() and (tabs[1][0, 4:] == 1.0).all()


class TestConstantTraceDegeneracy:
    """A single constant phase with throttling off reproduces the static
    model bitwise, NaN validity pattern included."""

    KW = dict(sensor_nodes=("7nm", "16nm"), weight_mems=("sram", "mram"),
              detnet_fps=(5.0, 30.0))

    def test_static_channels_bitwise(self):
        r_static = sweep.evaluate_grid(**self.KW, **CPU)
        r_scen = sweep.evaluate_grid(scenarios=_single(600.0), **self.KW,
                                     **CPU)
        assert tuple(r_scen.axes)[-1] == "trace"
        for f in sweep.FIELDS:
            assert np.array_equal(r_static.data[f], r_scen.data[f][..., 0],
                                  equal_nan=True), f

    def test_session_channels_inherit_validity(self):
        r_static = sweep.evaluate_grid(**self.KW, **CPU)
        r_scen = sweep.evaluate_grid(scenarios=_single(600.0), **self.KW,
                                     **CPU)
        nan = np.isnan(r_static.data["avg_power"])
        assert nan.any()
        for f in sweep.SCENARIO_FIELDS:
            assert np.array_equal(np.isnan(r_scen.data[f][..., 0]), nan), f

    def test_unthrottled_session_never_throttles(self):
        r = sweep.evaluate_grid(scenarios=_single(600.0), **self.KW, **CPU)
        tf = r.data["throttle_fraction"]
        assert (tf[np.isfinite(tf)] == 0.0).all()


# ---------------------------------------------------------------------------
# Stream vs dense (the port against itself)
# ---------------------------------------------------------------------------


class TestStreamParity:
    """Streaming reductions over session channels equal the dense grid's,
    for every chunk size and scan fusion."""

    KW = dict(sensor_nodes=("7nm", "16nm"), weight_mems=("sram",),
              detnet_fps=(5.0, 15.0, 30.0))

    @pytest.fixture(scope="class")
    def dense(self):
        return sweep.evaluate_grid(scenarios="all", **self.KW, **CPU)

    @pytest.fixture(scope="class", params=[(256, 1), (256, 2), (4096, 1),
                                           (4096, 2)],
                    ids=["c256-k1", "c256-k2", "c4096-k1", "c4096-k2"])
    def streamed(self, request):
        chunk, scan = request.param
        return stream.stream_grid(objectives=OBJ, maximize=MAX,
                                  scenarios="all", chunk_size=chunk,
                                  scan_chunks=scan, top_k=5, track="all",
                                  **self.KW, **CPU)

    def test_argmin_matches_dense_bitwise(self, dense, streamed):
        win = streamed.argmin("peak_case_temp_c")
        assert win["peak_case_temp_c"] == np.nanmin(
            dense.data["peak_case_temp_c"])
        assert win == dense.argmin("peak_case_temp_c")
        assert win["trace"] in SC.PROFILES
        for f in sweep.FIELDS + sweep.SCENARIO_FIELDS:
            assert streamed.min_idx[f] == np.nanargmin(dense.data[f]), f

    def test_top_k_maximize_matches_dense(self, dense, streamed):
        tte = dense.data["time_to_empty_s"]
        want = np.sort(tte[np.isfinite(tte)])[::-1][:5]
        got = [p["time_to_empty_s"]
               for p in streamed.top_k("time_to_empty_s")]
        np.testing.assert_array_equal(got, want)
        assert list(streamed.topk_idx[0]) == list(top_k_flat(-tte, 5))

    def test_pareto_front_matches_dense(self, dense, streamed):
        ref = pareto.pareto_front(dense, objectives=OBJ, maximize=MAX)
        got = streamed.pareto_front()
        assert ref.objectives == got.objectives == OBJ
        assert np.array_equal(np.sort(ref.indices), np.sort(got.indices))
        assert {tuple(v) for v in np.asarray(ref.values)} == \
            {tuple(v) for v in np.asarray(got.values)}

    @pytest.mark.parametrize("chunk", [256, 4096])
    def test_constrained_stream_matches_dense(self, dense, chunk):
        res = stream.stream_grid(
            objectives=OBJ, maximize=MAX, constraints=TTE_TEMP,
            scenarios="all", chunk_size=chunk, **self.KW, **CPU)
        feas = dense.constrain(TTE_TEMP)
        tte = feas.data["time_to_empty_s"]
        assert np.isnan(tte).any() and not np.isnan(tte).all()
        best = res.top_k("time_to_empty_s")[0]["time_to_empty_s"]
        assert best == np.nanmax(tte[np.isfinite(tte)])
        front = pareto.pareto_front(feas, objectives=OBJ, maximize=MAX)
        assert np.array_equal(np.sort(front.indices),
                              np.sort(res.front_indices))

    def test_ranges_merge_bitwise(self, dense):
        """flat_range halves folded by merge_results equal the whole."""
        kw = dict(objectives=OBJ, maximize=MAX, scenarios="all",
                  chunk_size=64, scan_chunks=1, **self.KW, **CPU)
        whole = stream.stream_grid(**kw)
        n = whole.n_configs
        parts = [stream.stream_grid(**kw, flat_range=r)
                 for r in ((128, n), (0, 128))]
        merged = stream.merge_results(parts)
        assert merged.min_idx == whole.min_idx
        assert merged.min_val == whole.min_val
        assert np.array_equal(merged.topk_idx, whole.topk_idx)
        assert np.array_equal(merged.front_indices, whole.front_indices)
        assert merged.backend == "torch"


# ---------------------------------------------------------------------------
# Error messages without a reference counterpart call
# ---------------------------------------------------------------------------


class TestErrorMessages:

    def test_all_nan_session_channel_names_axis_values(self):
        r = sweep.evaluate_grid(cuts=(5, 11), sensor_nodes=("7nm",),
                                weight_mems=("mram",),
                                scenarios=_single(60.0), **CPU)
        with pytest.raises(ValueError, match="weight_mem='mram'") as ei:
            r.argmin("time_to_empty_s")
        assert "time_to_empty_s" in str(ei.value)

    def test_scenario_set_validation(self):
        with pytest.raises(ValueError, match="at least one trace"):
            SC.ScenarioSet(traces=())
        tr = SC.PROFILES["steady"]
        with pytest.raises(ValueError, match="duplicate"):
            SC.ScenarioSet(traces=(tr, tr))
        with pytest.raises(ValueError, match="steps_per_phase"):
            SC.ScenarioSet(traces=(tr,), steps_per_phase=0)

    def test_session_channels_need_scenarios_everywhere(self):
        with pytest.raises(ValueError, match="require scenarios="):
            stream.stream_grid(objectives=("avg_power",),
                               track=("throttle_fraction",), **CPU)
        with pytest.raises(ValueError, match="require scenarios="):
            stream.stream_grid(maximize=(), constraints={
                "time_to_empty_s": (">=", 1.0)}, **CPU)


# ---------------------------------------------------------------------------
# The scenario stack and its tables
# ---------------------------------------------------------------------------


def test_scenario_stack_delegates_and_is_cached():
    S, axis_arrays, axes = sweep.build_axes(cuts=(0, 3), scenarios="all")
    assert S.is_scenario and S.n_traces == 4
    assert [f.name for f in dataclasses.fields(S)] == ["S", "sset",
                                                       "step_tables"]
    assert S.fields == sweep.kernel_fields(S) == (sweep.FIELDS
                                                  + sweep.SCENARIO_FIELDS)
    assert sweep.kernel_fields(S.S) == sweep.FIELDS
    assert S.n_cuts_max == S.S.n_cuts_max
    assert S.node_index("16nm") == S.S.node_index("16nm")
    assert axes["trace"] == tuple(SC.PROFILES)
    assert axis_arrays[-1].tolist() == [0, 1, 2, 3]
    again, _, _ = sweep.build_axes(cuts=(0, 3), scenarios="all")
    assert again is S
    tabs = SC._step_tables(S.sset)
    assert all(t.shape == (4, 20) for t in tabs)
    assert np.isclose(tabs[0].sum(axis=1),
                      [t.duration_s for t in S.sset.traces]).all()
    T = B.device_tables(S, "cpu")
    assert set(SC.STEP_TABLES) <= set(T.views)
    assert not set(SC.STEP_TABLES) & set(B.device_tables(S.S, "cpu").views)
    assert B.lane_eval(S).func is SC.session_eval
    assert B.lane_eval(S.S) is sweep.config_eval
    for name, tab in zip(SC.STEP_TABLES, tabs):
        assert T[name].dtype == torch.float64
        assert np.array_equal(T[name].numpy(), tab)
    axv = sweep.axes_to_device(axis_arrays, "cpu")
    assert axv[-1].dtype == torch.int64 and axv[5].dtype == torch.float64


def test_chunk_step_folds_scenario_chunks_like_the_loop():
    """The chunk step (K = 2 folds a dispatch) over a scenario stack
    equals K = 1's, bitwise."""
    kw = dict(objectives=OBJ, maximize=MAX, scenarios="all",
              chunk_size=128, **SCENARIO_REF_GRID, **CPU)
    a = stream.stream_grid(**kw, scan_chunks=1)
    b = stream.stream_grid(**kw, scan_chunks=2)
    assert a.min_val == b.min_val and a.min_idx == b.min_idx
    assert np.array_equal(a.topk_val, b.topk_val)
    assert np.array_equal(a.front_values, b.front_values)


# ---------------------------------------------------------------------------
# Properties
# ---------------------------------------------------------------------------


def _tte_along(sset=None, **axis_kw):
    """time_to_empty_s as a 1-D array along one opened grid axis."""
    r = sweep.evaluate_grid(cuts=(11,), scenarios=sset or _single(600.0),
                            **axis_kw, **CPU)
    return np.squeeze(r.data["time_to_empty_s"])


def _resegmented(frac, dur):
    ref = _small_grid(_single(dur))
    split = SC.ScenarioSet(traces=(SC.ScenarioTrace(
        "const", (SC.Phase(frac * dur), SC.Phase((1 - frac) * dur))),),
        throttle=False)
    r2 = _small_grid(split)
    for f in sweep.SCENARIO_FIELDS:
        np.testing.assert_allclose(r2.data[f], ref.data[f], rtol=1e-9,
                                   err_msg=f)


class TestSessionProperties:
    """Monotonicity and invariance: deterministic cases that always run,
    plus hypothesis generalizations when it is installed."""

    def test_tte_monotone_in_power_draw_det(self):
        tte = _tte_along(mipi_energy_scale=(0.5, 1.0, 2.0, 4.0))
        assert (np.diff(tte) <= 0).all()

    @pytest.mark.parametrize("frac, dur", [(0.5, 256.0), (0.25, 128.0),
                                           (0.75, 512.0)])
    def test_resegmentation_invariance_det(self, frac, dur):
        _resegmented(frac, dur)

    def test_peak_temp_monotone_in_ambient_det(self):
        peaks = []
        for amb in (15.0, 25.0, 35.0):
            th = dataclasses.replace(DEFAULT_THERMAL, ambient_c=amb)
            peaks.append(_small_grid(_single(600.0, thermal=th))
                         .data["peak_case_temp_c"])
        assert (peaks[1] > peaks[0]).all() and (peaks[2] > peaks[1]).all()

    @given(lo=st.floats(0.25, 4.0), step=st.floats(0.1, 4.0))
    @settings(max_examples=10, deadline=None)
    def test_tte_monotone_in_power_draw(self, lo, step):
        tte = _tte_along(mipi_energy_scale=(lo, lo + step))
        assert tte[1] <= tte[0]

    @given(frac=st.sampled_from([0.25, 0.5, 0.75]),
           dur=st.sampled_from([128.0, 256.0, 512.0]))
    @settings(max_examples=10, deadline=None)
    def test_resegmentation_invariance(self, frac, dur):
        _resegmented(frac, dur)

    @given(amb=st.floats(0.0, 40.0), delta=st.floats(0.5, 15.0))
    @settings(max_examples=10, deadline=None)
    def test_peak_temp_monotone_in_ambient(self, amb, delta):
        lo = _small_grid(_single(600.0, thermal=dataclasses.replace(
            DEFAULT_THERMAL, ambient_c=amb)))
        hi = _small_grid(_single(600.0, thermal=dataclasses.replace(
            DEFAULT_THERMAL, ambient_c=amb + delta)))
        assert (hi.data["peak_case_temp_c"]
                > lo.data["peak_case_temp_c"]).all()


def test_progress_snapshots_resolve_to_trace_labels():
    """The delta codec carries flat indices (the reference's wire
    format); rebuilt from its deltas, a scenario stream's snapshots name
    front points whose configurations carry their trace labels."""
    seen, snap = [], None
    res = stream.stream_grid(
        objectives=OBJ, maximize=MAX, scenarios="all", chunk_size=16,
        scan_chunks=1, **SCENARIO_REF_GRID, **CPU,
        on_snapshot=seen.append, snapshot_every_s=0.0)
    for cur in seen:
        delta = stream.result_delta_to_json(snap, cur)
        snap = stream.apply_result_delta(snap, delta)
        assert snap == cur
    assert len(seen) > 2
    labels = {res.config_at(i)["trace"] for i in snap["front"]["i"]}
    assert labels and labels <= set(SC.PROFILES)
    assert snap["best"]["time_to_empty_s"]["value"] == \
        res.top_k("time_to_empty_s")[0]["time_to_empty_s"]
