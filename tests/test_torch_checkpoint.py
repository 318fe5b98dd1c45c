"""Checkpoints of the port's streaming executor on the CPU: the port's
``CheckpointManager`` against the JAX reference's (each reads the other's
directories: the same manifest paths and arrays, and the same state at
every step of one stream), aborted and resumed runs (an injected
exception, a SIGKILLed child, a kill inside a fused step, a resume from
a finished run) bitwise equal to the uninterrupted run, a stale
signature refused, the manager's atomic save, retention and debris
sweep, and ``optimal_partition``'s checkpoint plumbing."""

import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, run
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import backend as B
from repro_torch.core import partition, stream
from repro_torch.core.grids import REFERENCE_GRID

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
KW = dict(chunk_size=997, scan_chunks=3, prefetch=2, track="all")


def _stream(**kw):
    return stream.stream_grid(**REFERENCE_GRID, **KW, **kw, device="cpu")


def deliverables(res) -> tuple:
    def bits(a):
        return np.asarray(a, np.float64).tobytes()
    return (tuple(sorted(res.min_idx.items())),
            bits([res.min_val[f] for f in res.min_val]),
            tuple(sorted(res.finite_counts.items())),
            bits([res.channel_min[f] for f in res.channel_min]),
            bits([res.channel_max[f] for f in res.channel_max]),
            res.topk_idx.tobytes(), bits(res.topk_val),
            res.front_indices.tobytes(), bits(res.front_values))


@pytest.fixture(scope="module")
def whole():
    return _stream()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The port's checkpoints of one stream (every dispatch, all kept)
    and the reference's of the same stream, each read by the other."""
    root = tmp_path_factory.mktemp("ckpt")
    ours = str(root / "port")
    res = _stream(checkpoint_dir=ours, checkpoint_every_steps=1,
                  checkpoint_keep=10**6)
    ref = run("checkpoint", grid=REFERENCE_GRID, kw=KW,
              write=str(root / "reference"), read=ours)
    return {"port": ours, "reference": str(root / "reference"),
            "ref": ref, "res": res}


def _items(root):
    mgr = CheckpointManager(root, keep=10**6)
    return {s: (mgr.restore_items(s), mgr.metadata(s))
            for s in mgr.all_steps()}


def test_reference_reads_the_port_checkpoints(dirs):
    ours = _items(dirs["port"])
    theirs = dirs["ref"]["read"]
    assert sorted(theirs) == sorted(ours) and len(ours) > 2
    for step, (items, meta) in ours.items():
        got = theirs[step]
        assert list(got["items"]) == list(items)      # paths, in order
        for path, arr in items.items():
            assert got["items"][path].dtype == arr.dtype, path
            assert np.array_equal(got["items"][path], arr,
                                  equal_nan=True), path
        assert got["meta"] == json.loads(json.dumps(meta))


def test_port_reads_the_reference_checkpoints(dirs):
    ours = _items(dirs["reference"])
    theirs = dirs["ref"]["written"]
    assert sorted(theirs) == sorted(ours) and len(ours) > 2
    for step, (items, meta) in ours.items():
        assert list(items) == list(theirs[step]["items"])
        for path, arr in items.items():
            want = theirs[step]["items"][path]
            assert arr.dtype == want.dtype and arr.shape == want.shape
            assert np.array_equal(arr, want, equal_nan=True), path
        assert meta == theirs[step]["meta"]


def test_same_state_at_every_step(dirs):
    """The carry and front each side snapshots at each dispatch boundary
    of the same stream: index fields exact, values within 1e-12."""
    ours, theirs = _items(dirs["port"]), _items(dirs["reference"])
    assert sorted(ours) == sorted(theirs)
    for step in ours:
        a, b = ours[step][0], theirs[step][0]
        assert list(a) == list(b)
        for path in a:
            if a[path].dtype.kind == "f":
                assert_close(a[path], b[path], what=f"{step} {path}")
            else:
                assert np.array_equal(a[path], b[path]), (step, path)
        assert ours[step][1]["next_flat"] == theirs[step][1]["next_flat"]


def test_checkpointed_run_equals_plain_run(dirs, whole):
    assert deliverables(dirs["res"]) == deliverables(whole)
    assert dirs["res"].stats["checkpoints_written"] > 2


def test_injected_exception_then_resume(tmp_path, whole):
    def boom(ordinal, flat_start):
        if ordinal >= 6:
            raise RuntimeError("dispatch exploded")

    with pytest.raises(RuntimeError, match="exploded"):
        _stream(checkpoint_dir=str(tmp_path), checkpoint_every_steps=1,
                fault_injector=boom)
    res = _stream(checkpoint_dir=str(tmp_path), checkpoint_every_steps=1)
    assert res.stats["resumed_from_step"] == 6
    assert deliverables(res) == deliverables(whole)


_KILL = """
import sys
from repro_torch.core import stream
from repro_torch.core.grids import REFERENCE_GRID
from repro_torch.runtime import FaultInjector, FaultPlan
stream.stream_grid(**REFERENCE_GRID, chunk_size=997, scan_chunks=3,
                   prefetch=2, track="all", device="cpu",
                   checkpoint_dir=sys.argv[1], checkpoint_every_steps=1,
                   fault_injector=FaultInjector(FaultPlan(
                       kill_at=int(sys.argv[2]))))
print("UNREACHABLE")
"""


@pytest.mark.parametrize("kill_at, resumed", [(6, 6), (4, 6), (9, 9)],
                         ids=["on_a_dispatch", "inside_a_fused_step",
                              "late"])
def test_sigkilled_child_then_resume(tmp_path, whole, kill_at, resumed):
    """A child killed with SIGKILL at a chunk ordinal (inside a fused
    step it fires at the dispatch that reaches it) leaves its last
    durable snapshot; a resume here is bitwise the uninterrupted run."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _KILL, str(tmp_path),
                          str(kill_at)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == -signal.SIGKILL, out.stderr[-2000:]
    assert "UNREACHABLE" not in out.stdout
    res = _stream(checkpoint_dir=str(tmp_path), checkpoint_every_steps=1)
    assert res.stats["resumed_from_step"] == resumed
    assert deliverables(res) == deliverables(whole)


def test_resume_from_a_finished_run(tmp_path, whole):
    first = _stream(checkpoint_dir=str(tmp_path))
    again = _stream(checkpoint_dir=str(tmp_path))
    assert again.stats["resumed_from_step"] == whole.n_configs // 997
    # nothing was dispatched again
    assert again.stats["first_chunk_s"] == again.stats["total_s"]
    assert deliverables(first) == deliverables(again) == deliverables(whole)


@pytest.mark.parametrize("change", [dict(top_k=5), dict(scan_chunks=2)])
def test_stale_signature_is_refused(tmp_path, change):
    _stream(checkpoint_dir=str(tmp_path))
    kw = dict(KW, **change)
    with pytest.raises(ValueError, match="different sweep job"):
        stream.stream_grid(**REFERENCE_GRID, **kw, device="cpu",
                           checkpoint_dir=str(tmp_path))


def test_ranged_checkpoints_do_not_cross_ranges(tmp_path):
    n = stream.plan_stream(**REFERENCE_GRID, device="cpu").n_total
    _stream(checkpoint_dir=str(tmp_path), flat_range=(0, 997 * 6))
    with pytest.raises(ValueError, match="different sweep job"):
        _stream(checkpoint_dir=str(tmp_path), flat_range=(997 * 6, n))


def test_manager_save_retention_and_debris(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"b": [np.arange(3), None, torch.tensor([1.5, 2.5])],
             "a": {"y": np.float64(2.0),
                   "x": torch.ones(2, 2, dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        mgr.save(step, state, metadata={"n": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    items = mgr.restore_items(3)
    assert list(items) == ["a/x", "a/y", "b/0", "b/2"]
    assert items["a/x"].dtype == torch.bfloat16
    assert torch.equal(items["a/x"], torch.ones(2, 2, dtype=torch.bfloat16))
    assert np.array_equal(items["b/0"], np.arange(3))
    assert mgr.metadata(3) == {"n": 3}
    back = mgr.restore(3, state)
    assert torch.equal(back["b"][2], torch.tensor([1.5, 2.5],
                                                  dtype=torch.float64))
    assert back["b"][1] is None
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(3, {"a": np.zeros(1)})
    # a crashed save's debris is swept; a dir without manifest is no step
    (tmp_path / "step_000000009.tmp").mkdir()
    (tmp_path / "step_000000010").mkdir()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert not (tmp_path / "step_000000009.tmp").exists()
    assert mgr.all_steps() == [2, 3]


def test_optimal_partition_plumbs_checkpoints(monkeypatch, tmp_path):
    """Above the stream threshold optimal_partition streams, and its
    checkpoint_dir / checkpoint_every_s reach stream_grid."""
    seen = {}
    real = stream.stream_grid

    def spy(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(partition, "STREAM_THRESHOLD", 1000)
    monkeypatch.setattr(stream, "stream_grid", spy)
    knobs = dict(agg_node=("7nm", "16nm"), sensor_node=("7nm", "16nm"),
                 detnet_fps=(5.0, 10.0, 15.0, 20.0, 30.0),
                 keynet_fps=(15.0, 30.0))
    got = partition.optimal_partition(device="cpu", **knobs,
                                      checkpoint_dir=str(tmp_path),
                                      checkpoint_every_s=5.0)
    assert seen["checkpoint_dir"] == str(tmp_path)
    assert seen["checkpoint_every_s"] == 5.0
    assert CheckpointManager(str(tmp_path)).latest_step() is not None
    monkeypatch.setattr(stream, "stream_grid", real)
    want = partition.optimal_partition(device="cpu", **knobs)
    assert got == want


def test_step_cache_stats_shape():
    stats = B.step_cache_stats()
    assert set(stats) == {"hits", "misses", "evictions", "size",
                          "capacity"}
    assert stats["size"] <= stats["capacity"]
