"""The streaming executor's spans and counters: each span a host-op
range that a profiler records under the sweep's one ``stream_grid``
range, never a user annotation (which the profiler mirrors with
device-side records of the same name), with the ``stats`` it times;
and the counters ``survivors`` and ``step_builds``."""

import ast
import pathlib
from collections import OrderedDict

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import backend as B
from repro_torch.core import spans, stream
from repro_torch.core.grids import REFERENCE_GRID

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"

#: Every range the program opens.
NAMES = {"stream_grid", "stream.probe", "stream.step_build",
         "stream.dispatch", "stream.wait", "stream.host", "stream.fallback",
         "stream.merge", "stream.checkpoint"}
#: The ``stats`` key each span adds its seconds to.
KEYS = {"stream_grid": "total_s", "stream.probe": "probe_s",
        "stream.step_build": "step_build_s", "stream.dispatch": "dispatch_s",
        "stream.wait": "device_wait_s", "stream.host": "host_merge_s",
        "stream.fallback": "fallback_s"}
GRID_2D = dict(REFERENCE_GRID, chunk_size=997,
               objectives=("avg_power", "latency"))
SESSIONS = dict(cuts=(0, 1), detnet_fps=(10.0, 30.0),
                camera_fps=(30.0, 60.0), scenarios="all", chunk_size=8,
                objectives=("time_to_empty_s", "peak_case_temp_c"),
                maximize=("time_to_empty_s",))
#: A cell kind each: the keyword arguments of the sweep, and whether it
#: forces survivor overflows and writes checkpoints (which adds the
#: fallback and checkpoint ranges).
KINDS = {"grid": (GRID_2D, False), "sessions": (SESSIONS, False),
         "grid_overflow_checkpoint": (dict(GRID_2D, chunk_size=2048), True)}


@pytest.fixture(autouse=True)
def _empty_step_cache(monkeypatch):
    """Plans of equal arguments share chunk steps: start from none."""
    monkeypatch.setattr(B, "_STEP_CACHE", OrderedDict())


def _plan(kind, monkeypatch, tmp_path):
    kw, forced = KINDS[kind]
    extra = {}
    if forced:
        monkeypatch.setattr(stream, "_SURVIVOR_CAP", 8)
        extra = dict(checkpoint_dir=str(tmp_path / "ckpt"),
                     checkpoint_every_steps=2)
    return stream.plan_stream(**kw, device="cpu"), extra


def _profiled(fn):
    """``fn()``'s result and the profile's records as ``(name, start_ns,
    end_ns, is_user_annotation)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    records = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                ev.is_user_annotation())
               for ev in prof.profiler.kineto_results.events()]
    return out, records


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_spans_are_host_op_ranges_under_one_sweep(kind, monkeypatch,
                                                  tmp_path):
    plan, extra = _plan(kind, monkeypatch, tmp_path)
    res, records = _profiled(
        lambda: stream.stream_grid(plan=plan, prefetch=2, **extra))
    ours = [r for r in records if r[0].startswith("stream")]
    found = {r[0] for r in ours}
    want = NAMES - ({"stream.fallback", "stream.checkpoint"}
                    if not KINDS[kind][1] else set())
    assert found == want
    assert not any(r[0].startswith("portbench") for r in records)
    assert not any(r[3] for r in ours), "a span became a user annotation"
    (whole,) = [r for r in ours if r[0] == "stream_grid"]
    for name, s, e, _ in ours:
        assert whole[1] <= s <= e <= whole[2], name
    # a range's seconds are its key's: a span times what its range covers
    for name, key in KEYS.items():
        if name in found:
            ranges_s = sum(e - s for n, s, e, _ in ours if n == name) / 1e9
            assert res.stats[key] == pytest.approx(ranges_s, rel=0.2,
                                                   abs=2e-3), name
    if KINDS[kind][1]:
        assert res.stats["fallback_chunks"] > 0
        assert res.stats["checkpoints_written"] > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_counters_and_shares_of_the_sweep(kind, monkeypatch, tmp_path):
    plan, extra = _plan(kind, monkeypatch, tmp_path)
    first = stream.stream_grid(plan=plan, **extra).stats
    again = stream.stream_grid(plan=plan).stats
    for st in (first, again):
        for key in ("probe_s", "device_wait_s", "host_merge_s",
                    "dispatch_s", "fallback_s", "step_build_s"):
            assert 0.0 <= st[key] <= st["total_s"], key
        assert st["probe_s"] > 0.0
        assert 0 < st["survivors"] <= st["n_configs"]
    assert first["step_builds"] == 1.0 and first["step_build_s"] > 0.0
    assert again["step_builds"] == 0.0 and again["step_build_s"] == 0.0


def test_survivors_count_what_reaches_the_host_buffer():
    """A one-objective sweep hands the host the pre-filter's few passes,
    its front among them."""
    plan = stream.plan_stream(**dict(REFERENCE_GRID, chunk_size=997,
                                     objectives=("avg_power",)),
                              device="cpu")
    res = stream.stream_grid(plan=plan)
    assert (1 <= res.front_indices.size <= res.stats["survivors"]
            < res.stats["n_configs"] / 10)


def test_a_failed_sweep_closes_its_ranges_and_its_stats():
    """A sweep that raises leaves no sweep current in the thread."""
    plan = stream.plan_stream(**GRID_2D, device="cpu")

    def injector(ordinal, start):
        if ordinal >= 2:
            raise ValueError("boom")

    def run():
        with pytest.raises(ValueError, match="boom"):
            stream.stream_grid(plan=plan, fault_injector=injector)

    _, records = _profiled(run)
    assert spans._STATS.get() is None
    assert [r[0] for r in records].count("stream_grid") == 1


def test_spans_outside_a_sweep_add_nowhere():
    into = {"k": 0.0}
    with spans.span("stream.test"):
        spans.count("step_builds")
    with spans.span("stream.test", "k", into):
        pass
    assert into["k"] > 0.0
    outer, inner = ({"total_s": 0.0, "n": 0.0} for _ in range(2))
    with spans.sweep("stream.test", "total_s", outer):
        spans.count("n", 2)
        with spans.sweep("stream.test", "total_s", inner):
            spans.count("n")
        spans.count("n")
    assert outer["n"] == 3.0 and inner["n"] == 1.0
    assert outer["total_s"] >= inner["total_s"] > 0.0
    assert spans._STATS.get() is None


def test_no_program_string_names_the_benchmark():
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert "portbench" not in node.value, path


def test_merge_results_sums_the_new_counters():
    plan = stream.plan_stream(**GRID_2D, device="cpu")
    per = plan.chunk * plan.scan
    cut = (plan.n_total // per // 2) * per
    parts = [stream.stream_grid(plan=plan, flat_range=r)
             for r in ((0, cut), (cut, plan.n_total))]
    merged = stream.merge_results(parts).stats
    for key in ("probe_s", "step_build_s", "step_builds", "survivors"):
        assert merged[key] == pytest.approx(
            sum(p.stats[key] for p in parts)), key
    assert np.isfinite(merged["survivors"])
