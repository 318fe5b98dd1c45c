"""Checkpoints of the port's streaming executor on the CPU: the port's
``CheckpointManager`` against the JAX reference's (each reads the other's
directories: the same manifest paths and arrays, and the same state at
every step of one stream), aborted and resumed runs (an injected
exception, a SIGKILLed child, a kill inside a fused step, a resume from
a finished run) bitwise equal to the uninterrupted run, a stale
signature refused, the manager's atomic save, retention and debris
sweep, and ``optimal_partition``'s checkpoint plumbing.  A scenario
stream's job signature is the reference's digest, and each package
resumes the other's scenario checkpoints."""

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
from repro_torch.core.grids import (REFERENCE_GRID, SCENARIO_OBJECTIVES,
                                    SCENARIO_REF_GRID)

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


def test_plain_signature_equals_reference(dirs):
    """The job signature is the reference's digest for a plain stream
    too (the backend enters under its reference name)."""
    kw = {k: v for k, v in KW.items() if k != "prefetch"}
    assert stream.plan_stream(**REFERENCE_GRID, **kw, device="cpu"
                              ).signature == dirs["ref"]["signature"]


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
from repro_torch.core.grids import (REFERENCE_GRID, SCENARIO_OBJECTIVES,
                                    SCENARIO_REF_GRID)
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


# ---------------------------------------------------------------------------
# Scenario streams across the two packages
# ---------------------------------------------------------------------------

SKW = dict(scenarios="all", objectives=SCENARIO_OBJECTIVES,
           maximize=("time_to_empty_s",), chunk_size=16, scan_chunks=1,
           track="all")
EARLY = 48          # the flat index an interrupted run stopped after


def _scen(**kw):
    return stream.stream_grid(**SCENARIO_REF_GRID, **SKW, **kw,
                              device="cpu")


@pytest.fixture(scope="module")
def scen(tmp_path_factory):
    """A scenario stream's checkpoints written by each package (every
    dispatch, all kept), each resumed by the other: from its finished
    state and from a copy cut back to flat index ``EARLY``."""
    root = tmp_path_factory.mktemp("scen")
    ours = str(root / "port")
    res = _scen(checkpoint_dir=ours, checkpoint_every_steps=1,
                checkpoint_keep=10**6)
    ref = run("checkpoint", grid=SCENARIO_REF_GRID, kw=SKW,
              write=str(root / "reference"), read=ours,
              resume={"finished": None, "early": EARLY})
    return {"port": ours, "reference": str(root / "reference"),
            "ref": ref, "res": res, "whole": _scen()}


def _cut_copy(src, dst, upto):
    import shutil
    shutil.copytree(src, dst)
    for d in pathlib.Path(dst).iterdir():
        if d.name.startswith("step_") and int(d.name[5:]) > upto:
            shutil.rmtree(d)
    return str(dst)


def _same_summary(got: dict, want: dict, exact: bool):
    """Two ``_stream_summary`` dicts: indices and counts equal, values
    bitwise (``exact``) or within 1e-12."""
    for key in ("min_idx", "finite"):
        assert got[key] == want[key], key
    for key in ("topk_idx", "front_idx"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("topk_val", "front_val"):
        if exact:
            assert np.asarray(got[key]).tobytes() == \
                np.asarray(want[key]).tobytes(), key
        else:
            assert_close(got[key], want[key], what=key)
    for f in want["min_val"]:
        if exact:
            assert got["min_val"][f] == want["min_val"][f], f
        else:
            assert_close(got["min_val"][f], want["min_val"][f], what=f)


def _summary(res) -> dict:
    fr = res.pareto_front()
    return {"min_idx": dict(res.min_idx), "min_val": dict(res.min_val),
            "finite": dict(res.finite_counts), "topk_idx": res.topk_idx,
            "topk_val": res.topk_val, "front_idx": fr.indices,
            "front_val": fr.values}


def test_scenario_signature_equals_reference(scen):
    sig = stream.plan_stream(**SCENARIO_REF_GRID, **SKW,
                             device="cpu").signature
    assert sig == scen["ref"]["signature"]
    for root in (scen["port"], scen["reference"]):
        mgr = CheckpointManager(root, keep=10**6)
        assert {mgr.metadata(s)["signature"]
                for s in mgr.all_steps()} == {sig}


def test_scenario_checkpoints_hold_the_same_state(scen):
    ours, theirs = _items(scen["port"]), _items(scen["reference"])
    assert sorted(ours) == sorted(theirs) and len(ours) == 9
    for step in ours:
        a, b = ours[step][0], theirs[step][0]
        assert list(a) == list(b)
        for path in a:
            if a[path].dtype.kind == "f":
                assert_close(a[path], b[path], what=f"{step} {path}")
            else:
                assert np.array_equal(a[path], b[path]), (step, path)


def test_reference_resumes_the_port_scenario_checkpoints(scen):
    """From the port's finished state the reference returns the port's
    deliverables bitwise (nothing is evaluated again); from the port's
    state at ``EARLY`` it finishes the stream itself, to the port's
    indices and values within 1e-12."""
    done = scen["ref"]["resumed"]["finished"]
    assert done["stats"]["resumed_from_step"] == 144 // 16
    _same_summary(done, _summary(scen["res"]), exact=True)
    early = scen["ref"]["resumed"]["early"]
    assert early["stats"]["resumed_from_step"] == EARLY // 16
    _same_summary(early, _summary(scen["whole"]), exact=False)


def test_port_resumes_the_reference_scenario_checkpoints(scen, tmp_path):
    """The reverse: the reference's finished state gives the reference's
    deliverables bitwise; its state at ``EARLY``, finished here, the
    port's own stream's indices and values within 1e-12."""
    done = _scen(checkpoint_dir=_cut_copy(scen["reference"],
                                          tmp_path / "done", 10**9))
    assert done.stats["resumed_from_step"] == 144 // 16
    _same_summary(_summary(done), scen["ref"]["summary"], exact=True)
    early = _scen(checkpoint_dir=_cut_copy(scen["reference"],
                                           tmp_path / "early", EARLY))
    assert early.stats["resumed_from_step"] == EARLY // 16
    _same_summary(_summary(early), _summary(scen["whole"]), exact=False)
    assert deliverables(scen["res"]) == deliverables(scen["whole"])


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


# ---------------------------------------------------------------------------
# The training state: params and an AdamWState (a named tuple)
# ---------------------------------------------------------------------------


def _train_state(seed=0):
    from repro_torch.optim import adamw
    rng = np.random.default_rng(seed)
    params = {"w": torch.as_tensor(rng.standard_normal((3, 4))
                                   .astype(np.float32)),
              "b": torch.as_tensor(rng.standard_normal(4)
                                   .astype(np.float32)).bfloat16(),
              "layers": [{"scale": torch.as_tensor(rng.standard_normal(5)
                                                   .astype(np.float32))}]}
    opt = adamw.init(adamw.AdamWConfig(), params)
    opt = opt._replace(step=opt.step + 7,
                       mu=adamw._map(lambda t: t + 0.5, opt.mu))
    return {"params": params, "opt": opt}


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree)


def test_adamw_state_saves_and_restores_bitwise(tmp_path):
    """The training driver's state round-trips: the named tuple comes
    back as an ``AdamWState``, every leaf bitwise with its dtype, as CPU
    tensors."""
    from repro_torch.optim import adamw
    state = _train_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    got = mgr.restore(3, state)
    assert isinstance(got["opt"], adamw.AdamWState)
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(state)]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(state)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_named_tuple_fields_are_named_in_the_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _train_state())
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        paths = [leaf["path"] for leaf in json.load(f)["leaves"]]
    assert paths == ["opt/step", "opt/mu/b", "opt/mu/layers/0/scale",
                     "opt/mu/w", "opt/nu/b", "opt/nu/layers/0/scale",
                     "opt/nu/w", "params/b", "params/layers/0/scale",
                     "params/w"]


def test_adamw_checkpoints_cross_read_with_the_reference(tmp_path):
    """The reference's manager writes the same state (its AdamWState
    over numpy parameters) under the same manifest paths, the port
    restores it, and the reference restores the port's."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(3)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    params = {k: torch.as_tensor(v) for k, v in arrays.items()}
    ours = {"params": params,
            "opt": adamw.init(adamw.AdamWConfig(), params)}
    CheckpointManager(str(tmp_path / "port")).save(2, ours)
    ref = run("adamw_checkpoint",
              params={k: v.tolist() for k, v in arrays.items()},
              write=str(tmp_path / "reference"), read=str(tmp_path / "port"),
              read_step=2)
    with open(tmp_path / "port" / "step_000000002" / "manifest.json") as f:
        port_paths = [leaf["path"] for leaf in json.load(f)["leaves"]]
    assert ref["paths"] == port_paths
    assert port_paths[:3] == ["opt/step", "opt/mu/b", "opt/mu/w"]
    got = CheckpointManager(str(tmp_path / "reference")).restore(1, ours)
    assert isinstance(got["opt"], adamw.AdamWState)
    for k, v in arrays.items():
        assert torch.equal(got["params"][k], torch.as_tensor(v))
        assert torch.equal(got["opt"].mu[k], torch.zeros_like(params[k]))
        assert np.array_equal(ref["restored"]["params"][k], v)
        assert np.array_equal(ref["restored"]["nu"][k], np.zeros_like(v))
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 0
    assert int(ref["restored"]["step"]) == 0
