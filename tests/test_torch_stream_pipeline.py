"""The port's streaming executor on the CPU, beyond its synchronous core:
scan fusion (``scan_chunks``) and prefetch against the JAX reference's
runs with the same arguments (argmin, top-k and front index sets exact,
values within 1e-12 relative) and bitwise against the port's own
synchronous run; ``plan_stream``'s geometry against the reference's
(including a grid where only the fused dispatch crosses 2³¹);
``flat_range`` + ``merge_results``; ``should_stop`` prefixes; retries,
restarts and device loss under fault injection; the hooks and the
result codecs; and that a failing consumer leaves nothing in flight.
All on the 10,880-config reference grid."""

import json
import threading

import numpy as np
import pytest

from _jax_reference import assert_close, run
from repro_torch.core import backend as B
from repro_torch.core import stream
from repro_torch.core.grids import REFERENCE_GRID, stream_grid_axes
from repro_torch.runtime import (DeviceLostError, FaultInjector, FaultPlan,
                                 RetryPolicy, TransientDeviceError)

RUNS = {f"c{c}_s{s or 'auto'}_p{p}": dict(chunk_size=c, scan_chunks=s,
                                          prefetch=p, track="all")
        for c in (997, 4096) for s in (1, 3, None) for p in (0, 2)}
RUNS["c997_s3_p2_cons_max_hist"] = dict(
    chunk_size=997, scan_chunks=3, prefetch=2,
    objectives=("avg_power", "sensor_macs_per_s"),
    maximize=("sensor_macs_per_s",), constraints={"latency": 0.0283},
    hist_bins=16)
#: The same arguments, synchronous and unfused: what each run is held to
#: bitwise.
SYNC = {name: dict(kw, scan_chunks=1, prefetch=0)
        for name, kw in RUNS.items()}

#: n_total + chunk < 2³¹ <= n_total + chunk * scan: only the fused
#: dispatch needs 64-bit decode arithmetic (planned, never evaluated).
EDGE_GRID = dict(REFERENCE_GRID, camera_n=197_300)
PLANS = {
    "reference_c997": (REFERENCE_GRID, dict(chunk_size=997)),
    "reference_default": (REFERENCE_GRID, {}),
    "reference_scan5": (REFERENCE_GRID, dict(chunk_size=4096,
                                             scan_chunks=5)),
    "10m": (stream_grid_axes(10**7), {}),
    "100m": (stream_grid_axes(10**8), {}),
    "100m_c65536": (stream_grid_axes(10**8), dict(chunk_size=65536)),
    "edge": (EDGE_GRID, {}),
}
RANGE_KW = dict(chunk_size=997, scan_chunks=2, prefetch=2, track="all")
RANGE_CUT = 997 * 2 * 3


def _grid(g):
    g = dict(g)
    n = g.pop("camera_n", None)
    if n is not None:
        g["camera_fps"] = tuple(np.linspace(20.0, 60.0, n))
    return g


@pytest.fixture(scope="module")
def ref():
    return run("stream_pipeline", grid=REFERENCE_GRID, runs=RUNS,
               plans=PLANS, ranges=dict(kw=RANGE_KW, cut=RANGE_CUT))


def _stream(**kw):
    return stream.stream_grid(**REFERENCE_GRID, **kw, device="cpu")


@pytest.fixture(scope="module")
def ours():
    return {name: _stream(**kw) for name, kw in RUNS.items()}


@pytest.fixture(scope="module")
def sync():
    return {name: _stream(**kw) for name, kw in SYNC.items()}


def deliverables(res) -> tuple:
    """Everything a result reduces, as exact values (floats by bits)."""
    def bits(a):
        return np.asarray(a, np.float64).tobytes()
    hist = (tuple((f, c.tobytes(), e.tobytes())
                  for f, (c, e) in sorted(res.hist.items()))
            if res.hist else None)
    return (tuple(sorted(res.min_idx.items())),
            bits([res.min_val[f] for f in res.min_val]),
            tuple(sorted(res.finite_counts.items())),
            bits([res.channel_min[f] for f in res.channel_min]),
            bits([res.channel_max[f] for f in res.channel_max]),
            res.topk_idx.tobytes(), bits(res.topk_val),
            res.front_indices.tobytes(), bits(res.front_values), hist)


def _matches_reference(res, want):
    assert res.min_idx == want["min_idx"]
    assert res.finite_counts == want["finite"]
    for f in res.min_val:
        assert_close(res.min_val[f], want["min_val"][f], what=f)
        assert_close((res.channel_min[f], res.channel_max[f]),
                     want["bounds"][f], what=f)
    assert np.array_equal(res.topk_idx, want["topk_idx"])
    assert_close(res.topk_val, want["topk_val"], what="topk")
    front = res.pareto_front()
    assert np.array_equal(front.indices, want["front_idx"])
    assert_close(front.values, want["front_val"], what="front")
    if want["hist"] is not None:
        for f, (counts, _) in res.hist.items():
            assert np.array_equal(counts, want["hist"][f]), f


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_reference(ours, ref, name):
    _matches_reference(ours[name], ref["runs"][name])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_bitwise_equals_own_synchronous_run(ours, sync, name):
    assert deliverables(ours[name]) == deliverables(sync[name])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_stats_carry_the_reference_keys(ours, ref, name):
    got, want = ours[name].stats, ref["runs"][name]["stats"]
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for key in ("scan_chunks", "prefetch", "n_chunks", "fraction_complete",
                "range_start", "range_stop", "retries", "restarts"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_reference(ref, name):
    grid, kw = PLANS[name]
    plan = stream.plan_stream(**_grid(grid), **kw, device="cpu")
    want = ref["plans"][name]
    assert plan.n_total == want["n_total"]
    assert (plan.chunk, plan.scan, plan.spec.survivor_cap,
            plan.spec.small_index) == (want["chunk"], want["scan"],
                                       want["survivor_cap"],
                                       want["small_index"])
    assert want["stable"]
    again = stream.plan_stream(**_grid(grid), **kw, device="cpu")
    assert plan.signature == again.signature


def test_edge_plan_needs_the_fused_dispatch_for_64_bits():
    plan = stream.plan_stream(**_grid(EDGE_GRID), device="cpu")
    assert plan.scan == 8
    assert plan.n_total + plan.chunk < 2**31 <= (plan.n_total
                                                  + plan.chunk * plan.scan)
    assert not plan.spec.small_index


@pytest.mark.parametrize("change", [
    dict(chunk_size=4096), dict(top_k=5), dict(track=("camera",)),
    dict(maximize=("mipi_bytes_per_s",)), dict(objectives=("avg_power",)),
    dict(constraints={"latency": 0.03}), dict(hist_bins=8),
    dict(scan_chunks=2), dict(backend="cuda"),
    dict(detnet_fps=(5.0, 10.0, 15.0, 20.0, 31.0)),
])
def test_signature_changes_with_the_job(change):
    kw = dict(REFERENCE_GRID, chunk_size=997)
    base = stream.plan_stream(**kw, device="cpu")
    other = stream.plan_stream(**dict(kw, **change), device="cpu")
    assert other.signature != base.signature


def test_signature_ignores_survivor_cap_and_filter_geometry(monkeypatch):
    base = stream.plan_stream(**REFERENCE_GRID, device="cpu").signature
    monkeypatch.setattr(stream, "_SURVIVOR_CAP", 8)
    monkeypatch.setattr(stream, "_FILTER_ROWS", 12)
    assert stream.plan_stream(**REFERENCE_GRID,
                              device="cpu").signature == base


@pytest.fixture(scope="module")
def whole():
    return _stream(**RANGE_KW)


def test_flat_range_halves_merge_to_the_whole(whole, ref):
    n = whole.n_configs
    parts = [_stream(**RANGE_KW, flat_range=r)
             for r in ((RANGE_CUT, n), (0, RANGE_CUT))]
    assert [p.stats["range_start"] for p in parts] == [RANGE_CUT, 0.0]
    merged = stream.merge_results(parts)
    assert deliverables(merged) == deliverables(whole)
    assert not merged.partial and merged.stats["n_parts"] == 2.0
    _matches_reference(merged, ref["merged"])
    for got, want in zip(parts, ref["parts"]):
        _matches_reference(got, want)


@pytest.mark.parametrize("case", ["outside", "quantum", "gap", "partial",
                                  "mismatch"])
def test_flat_range_and_merge_errors(whole, ref, case):
    n = whole.n_configs
    if case in ref["errors"]:
        assert ref["errors"][case] is not None      # the reference raises
    calls = {
        "outside": lambda: _stream(**RANGE_KW, flat_range=(0, n + 1)),
        "quantum": lambda: _stream(**RANGE_KW,
                                   flat_range=(0, RANGE_CUT + 1)),
        "gap": lambda: stream.merge_results(
            [_stream(**RANGE_KW, flat_range=(RANGE_CUT, n))]),
        "partial": lambda: stream.merge_results(
            [_stream(**RANGE_KW, should_stop=_StopAfter(1))]),
        "mismatch": lambda: stream.merge_results(
            [_stream(**RANGE_KW, flat_range=(0, RANGE_CUT)),
             _stream(**RANGE_KW, objectives=("avg_power",),
                     flat_range=(RANGE_CUT, n))]),
    }
    match = {"outside": "outside the grid", "quantum": "dispatch quantum",
             "gap": "gap/overlap", "partial": "partial",
             "mismatch": "different sweep specifications"}[case]
    with pytest.raises(ValueError, match=match):
        calls[case]()


class _StopAfter:
    """``should_stop`` hook returning True after ``n`` dispatches."""

    def __init__(self, n: int):
        self.n, self.calls = n, 0

    def __call__(self) -> bool:
        self.calls += 1
        return self.calls > self.n


@pytest.mark.parametrize("prefetch", (0, 2))
def test_should_stop_prefix_equals_a_flat_range_run(whole, tmp_path,
                                                    prefetch):
    per_step = 997 * 2
    kw = dict(RANGE_KW, prefetch=prefetch)
    part = _stream(**kw, should_stop=_StopAfter(3),
                   checkpoint_dir=str(tmp_path), checkpoint_every_steps=1)
    assert part.partial
    assert part.stats["fraction_complete"] * whole.n_configs == 3 * per_step
    ranged = _stream(**kw, flat_range=(0, 3 * per_step))
    assert deliverables(part) == deliverables(ranged)
    done = _stream(**kw, checkpoint_dir=str(tmp_path),
                   checkpoint_every_steps=1)
    assert not done.partial
    assert done.stats["resumed_from_step"] == 6     # chunk ordinal
    assert deliverables(done) == deliverables(whole)


def test_never_stopping_hook_and_progress(whole):
    seen, snaps = [], []
    res = _stream(**RANGE_KW, should_stop=lambda: False,
                  on_progress=seen.append, on_snapshot=snaps.append,
                  snapshot_every_s=0.0)
    assert not res.partial and res.stats["fraction_complete"] == 1.0
    assert deliverables(res) == deliverables(whole)
    assert seen == sorted(seen) and seen[-1] == 1.0
    assert len(seen) == res.stats["n_chunks"]
    assert snaps and all(s["partial"] for s in snaps)
    fr = [s["fraction_complete"] for s in snaps]
    assert fr == sorted(fr) and fr[-1] == 1.0
    assert snaps[-1]["front"]["i"] == [int(i) for i in res.front_indices]
    # the delta codec rebuilds every snapshot from its predecessor
    prev = None
    for snap in snaps:
        delta = json.loads(json.dumps(stream.result_delta_to_json(prev,
                                                                  snap)))
        prev = stream.apply_result_delta(prev, delta)
        assert prev == json.loads(json.dumps(snap))


def test_snapshots_follow_durable_checkpoints(tmp_path):
    """A snapshot that reports progress past a checkpoint due at that
    step is emitted only after the checkpoint is on disk."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), keep=10**6)
    seen = []

    def on_snapshot(snap):
        seen.append((snap["fraction_complete"], mgr.all_steps()))

    res = _stream(**RANGE_KW, checkpoint_dir=str(tmp_path),
                  checkpoint_every_steps=1, checkpoint_keep=10**6,
                  on_snapshot=on_snapshot, snapshot_every_s=0.0)
    n = res.n_configs
    for frac, steps in seen[:-1]:
        assert round(frac * n) in steps, (frac, steps)


@pytest.mark.parametrize("name", ["c997_s3_p2", "c997_s3_p2_cons_max_hist"])
def test_codec_round_trip_is_bitwise(ours, name):
    res = ours[name]
    back = stream.result_from_json(json.loads(json.dumps(
        stream.result_to_json(res))))
    assert deliverables(back) == deliverables(res)
    assert back.axes == res.axes and back.stats == res.stats
    assert (back.n_devices, back.partial, back.constraints) == (
        res.n_devices, res.partial, res.constraints)


@pytest.mark.parametrize("name", ["c997_sauto_p2", "c4096_s3_p0",
                                  "c997_s3_p2_cons_max_hist"])
def test_result_to_json_matches_reference(ours, ref, name):
    got = json.loads(json.dumps(stream.result_to_json(ours[name])))
    want = ref["runs"][name]["json"]
    assert set(got) == set(want)
    for key in want:
        if key == "stats":
            assert set(want[key]) <= set(got[key])
        elif key in ("min_val", "channel_min", "channel_max"):
            assert got[key].keys() == want[key].keys()
            for f in want[key]:
                assert_close(got[key][f], want[key][f], what=f)
        elif key in ("topk_val", "front_values"):
            assert_close(got[key], want[key], what=key)
        elif key == "hist" and want[key] is not None:
            for f, (counts, edges) in want[key].items():
                assert got[key][f][0] == counts
                assert_close(got[key][f][1], edges, what=f)
        else:
            assert got[key] == want[key], key


class _Raise:
    """A fault injector raising ``exc`` once, at chunk ordinal ``at``."""

    def __init__(self, at: int, exc):
        self.at, self.exc, self.fired = at, exc, False

    def __call__(self, ordinal, flat_start):
        if ordinal >= self.at and not self.fired:
            self.fired = True
            raise self.exc


@pytest.mark.parametrize("prefetch", (0, 2))
def test_transient_faults_retry_in_place_to_parity(whole, prefetch):
    inj = FaultInjector(FaultPlan(fail_chunks=(2, 7)))
    res = _stream(**dict(RANGE_KW, prefetch=prefetch), fault_injector=inj,
                  retry_policy=RetryPolicy(backoff_s=0.0))
    assert inj.injected["transient"] == 2
    assert res.stats["retries"] == 2.0 and res.stats["restarts"] == 0.0
    assert deliverables(res) == deliverables(whole)


def test_spent_retries_raise():
    inj = FaultInjector(FaultPlan(transient_rate=1.0, seed=1))
    with pytest.raises(TransientDeviceError):
        _stream(**RANGE_KW, fault_injector=inj,
                retry_policy=RetryPolicy(max_retries=0, max_restarts=0,
                                         backoff_s=0.0))


@pytest.mark.parametrize("fault", ["spent_retries", "lose_device"])
def test_restart_from_snapshot_reaches_parity(whole, tmp_path, fault):
    if fault == "lose_device":
        inj = FaultInjector(FaultPlan(lose_device=(5, 0)))
    else:
        inj = _Raise(5, TransientDeviceError("spent"))
    res = _stream(**RANGE_KW, fault_injector=inj,
                  checkpoint_dir=str(tmp_path), checkpoint_every_steps=1,
                  retry_policy=RetryPolicy(max_retries=0, backoff_s=0.0))
    assert res.stats["restarts"] == 1.0
    assert res.stats["chunks_reissued"] > 0
    assert deliverables(res) == deliverables(whole)


def test_lost_device_without_restarts_raises():
    inj = FaultInjector(FaultPlan(lose_device=(3, 0)))
    with pytest.raises(DeviceLostError):
        _stream(**RANGE_KW, fault_injector=inj,
                retry_policy=RetryPolicy(max_restarts=0))


def _no_producer_left(before):
    assert threading.active_count() == before
    assert stream._Fetch.in_use == 0


@pytest.mark.parametrize("exc", [RuntimeError("merge exploded"),
                                 KeyboardInterrupt()],
                         ids=["exception", "keyboard_interrupt"])
def test_consumer_failure_leaves_nothing_in_flight(monkeypatch, exc):
    def boom(*a, **k):
        raise exc

    before = threading.active_count()
    monkeypatch.setattr(stream, "_merge_into_front", boom)
    with pytest.raises(type(exc)):
        _stream(chunk_size=997, scan_chunks=2, prefetch=2)
    _no_producer_left(before)
    # the step is released: the next run of the same spec reuses it
    monkeypatch.undo()
    res = _stream(chunk_size=997, scan_chunks=2, prefetch=2)
    assert res.front_indices.size
    _no_producer_left(before)


def test_step_cache_reuses_the_plan_step():
    plan = stream.plan_stream(**REFERENCE_GRID, chunk_size=997,
                              scan_chunks=2, device="cpu")
    stream.stream_grid(plan=plan)
    before = B.step_cache_stats()
    a = stream.stream_grid(plan=plan)
    after = B.step_cache_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    b = stream.stream_grid(plan=plan, prefetch=0)
    assert deliverables(a) == deliverables(b)


def test_step_state_is_written_in_place():
    """A step's buffers keep their addresses across loads and runs (a
    captured graph holds them), and a busy step is not shared."""
    plan = stream.plan_stream(**REFERENCE_GRID, chunk_size=997,
                              scan_chunks=3, constraints={"latency": 0.03},
                              hist_bins=8, device="cpu")
    step = B.build_step(plan.spec, plan.backend, "cpu", plan.scan)

    def addresses():
        return ([t.data_ptr() for t in step.carry.values()]
                + [t.data_ptr() for t in step.axvals]
                + [t.data_ptr() for t in step.aux["filter"].values()]
                + [step.aux["cons"].data_ptr(),
                   step.aux["hist_edges"].data_ptr(), step.base.data_ptr()])

    before = addresses()
    front = np.array([[0.01, 0.02, 3e5], [0.02, 0.01, 4e5]])
    step.load(carry=B.init_carry(plan.spec), axvals=plan.axis_vals,
              cons=np.array([0.03]), hist_edges=np.zeros((3, 9)),
              filt=stream.P.build_dominance_filter(front, 3, 24, 256))
    flat, vals, cnt = step(997 * 3)
    assert flat.shape == (3, plan.spec.survivor_cap)
    assert vals.shape == (3, plan.spec.survivor_cap, 3)
    assert cnt.shape == (3,)
    assert int(step.base) == 997 * 3
    assert addresses() == before
    a = B.cached_step(plan.spec, plan.backend, plan.scan, "cpu")
    b = B.cached_step(plan.spec, plan.backend, plan.scan, "cpu")
    assert a is not b and a.busy and b.busy
    a.busy = b.busy = False
    assert B.cached_step(plan.spec, plan.backend, plan.scan, "cpu") is a
