"""The port's multi-shard streaming and elastic replan on the CPU.

``stream_grid(devices=...)`` shards each dispatch over a list of devices
in which an entry may repeat; four CPU shards stand for the reference's
four host devices (``--xla_force_host_platform_device_count=4`` in the
reference's child only, ``tests/_jax_reference.py``), as the reference's
own tests run its ``pmap`` path.  Held here:

* ``runtime.elastic`` on the reference's ``tests/test_elastic.py`` cases;
* four, three and two shards against the reference's run on as many
  devices of the same grid (``tests/test_stream.py``'s): argmin, top-k,
  counts, bounds and front exactly (values within 1e-12: XLA contracts
  some operations the port rounds one by one), the device count, the
  chunk and the dispatch count; and against the dense path;
* a lost device, 4 -> 3 and 2 -> 1 shards: the reference's replan and
  re-issue counts, and bitwise the uninterrupted run (and the one-shard
  run);
* the plans' chunk, scan and signature for one to four devices, and the
  ``flat_range`` quantum error, against the reference's;
* a four-shard run SIGKILLed in a child and resumed here; the
  reference's four-device checkpoints resumed by the port on four shards
  and on one, and the port's resumed by the reference;
* the ``"cuda"`` backend's refusal of several shards, the automatic
  device list and the step cache's shard keys.
"""

import os
import pathlib
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, run
from repro_torch.core import backend as B
from repro_torch.core import stream
from repro_torch.core.grids import REFERENCE_GRID
from repro_torch.runtime import (FaultInjector, FaultPlan, MeshPlan,
                                 drop_worker, replan_mesh, rescale_batch)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
KW = dict(chunk_size=256, top_k=4, track="all")
CPU4 = ("cpu",) * 4

# ---------------------------------------------------------------------------
# runtime.elastic: the reference's cases
# ---------------------------------------------------------------------------


def _repeated_drops():
    pool = tuple(f"d{i}" for i in range(4))
    while len(pool) > 1:
        pool = drop_worker(pool, 0)
    return pool


ELASTIC_CASES = {
    "drop_middle_preserves_order": (
        lambda: drop_worker(("d0", "d1", "d2", "d3"), 1), ("d0", "d2", "d3")),
    "drop_first": (lambda: drop_worker(("d0", "d1", "d2"), 0), ("d1", "d2")),
    "drop_last": (lambda: drop_worker(("d0", "d1", "d2"), 2), ("d0", "d1")),
    "out_of_range_drops_last": (
        lambda: (drop_worker(("d0", "d1", "d2"), 99),
                 drop_worker(("d0", "d1", "d2"), -3)),
        (("d0", "d1"), ("d0", "d1"))),
    "drop_last_worker_raises": (lambda: drop_worker(("d0",), 0),
                                "cannot drop the last worker"),
    "empty_pool_raises": (lambda: drop_worker((), 0),
                          "cannot drop the last worker"),
    "repeated_drops_stop_at_one": (_repeated_drops, ("d3",)),
    "model_axis_kept": (lambda: replan_mesh(48, model=16),
                        MeshPlan(("data", "model"), (3, 16), 0)),
    "remainder_chips_become_spares": (
        lambda: replan_mesh(50, model=16),
        MeshPlan(("data", "model"), (3, 16), 2)),
    "degenerate_shrinks_model": (lambda: replan_mesh(6, model=16),
                                 MeshPlan(("data", "model"), (1, 4), 2)),
    "pod_axis_preserved": (lambda: replan_mesh(64, model=16, pods=2),
                           MeshPlan(("pod", "data", "model"), (2, 2, 16), 0)),
    "single_chip": (lambda: replan_mesh(1, model=16).shape, (1, 1)),
    "chips": (lambda: (replan_mesh(48, model=16).chips,
                       replan_mesh(1, model=16).chips), (48, 1)),
    "keep_global_batch": (lambda: rescale_batch(256, old_data=8, new_data=6),
                          256),
    "scale_with_data_axis": (
        lambda: rescale_batch(256, old_data=8, new_data=6,
                              keep_global=False), 192),
}


@pytest.mark.parametrize("name", list(ELASTIC_CASES))
def test_elastic_policy(name):
    fn, want = ELASTIC_CASES[name]
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            fn()
    else:
        assert fn() == want


# ---------------------------------------------------------------------------
# Sharded streams against the reference's multi-device runs
# ---------------------------------------------------------------------------

RUNS = {
    "four": dict(n_devices=4, kw=KW),
    "three": dict(n_devices=3, kw=dict(KW, scan_chunks=2)),
    "two": dict(n_devices=2, kw=dict(KW, prefetch=0)),
    "lost_4_to_3": dict(n_devices=4, kw=KW, lose_device=[5, 2]),
    "lost_2_to_1": dict(n_devices=2, kw=KW, lose_device=[2, 0]),
}
PLANS = [["one", 1, KW], ["two", 2, KW], ["three", 3, KW], ["four", 4, KW],
         ["four_default_chunk", 4, {}], ["one_default_chunk", 1, {}],
         ["three_scan3", 3, dict(KW, chunk_size=997, scan_chunks=3)]]


@pytest.fixture(scope="module")
def ref():
    return run("stream_devices", host_devices=4, grid=REFERENCE_GRID,
               runs=RUNS, plans=PLANS, quantum_kw=KW)


def _run(name, **extra):
    r = RUNS[name]
    inj = (FaultInjector(FaultPlan(lose_device=tuple(r["lose_device"])))
           if r.get("lose_device") else None)
    return stream.stream_grid(**REFERENCE_GRID, **r["kw"],
                              devices=("cpu",) * r["n_devices"],
                              fault_injector=inj, **extra)


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
def one_shard():
    return stream.stream_grid(**REFERENCE_GRID, **KW, device="cpu")


def test_reference_ran_on_four_devices(ref):
    assert ref["n_host_devices"] == 4


@pytest.mark.parametrize("name", list(RUNS))
def test_shards_match_reference(ref, name):
    want = ref["runs"][name]
    res = _run(name)
    assert res.n_devices == want["n_devices"] == RUNS[name]["n_devices"]
    assert res.chunk_size == want["chunk_size"]
    for key in ("n_chunks", "scan_chunks", "elastic_replans",
                "chunks_reissued", "restarts"):
        assert res.stats[key] == want["stats"][key], key
    assert res.min_idx == want["min_idx"]
    assert res.finite_counts == want["finite"]
    assert np.array_equal(res.topk_idx, want["topk_idx"])
    front = res.pareto_front()
    assert np.array_equal(front.indices, want["front_idx"])
    assert_close(front.values, want["front_val"], what="front")
    assert_close(res.topk_val, want["topk_val"], what="top-k")
    for f in res.min_val:
        assert_close(res.min_val[f], want["min_val"][f], what=f)
        assert_close([res.channel_min[f], res.channel_max[f]],
                     want["bounds"][f], what=f)
    assert {o: res.top_k(o) for o in res.objectives} == want["top_k"]
    dense = ref["dense"]
    for f in res.min_val:
        assert res.argmin(f) == want["argmin"][f] == dense["argmin"][f], f
        assert res.finite_counts[f] == dense["finite"][f], f
    for o in res.objectives:
        assert res.top_k(o) == dense["top_k"][o], o
    assert np.array_equal(front.indices, dense["front_idx"])
    assert_close(front.values, dense["front_val"], what="dense front")


@pytest.mark.parametrize("name,uninterrupted",
                         [("lost_4_to_3", "four"), ("lost_2_to_1", "two")])
def test_device_loss_is_bitwise_the_uninterrupted_run(ref, one_shard, name,
                                                      uninterrupted):
    lost = _run(name)
    assert lost.stats["elastic_replans"] == 1.0
    assert lost.stats["chunks_reissued"] > 0.0
    assert lost.stats["restarts"] == 0.0
    assert ref["runs"][name]["device_lost"] == 1
    whole = stream.stream_grid(**REFERENCE_GRID, **KW,
                               devices=("cpu",) * RUNS[name]["n_devices"])
    assert deliverables(lost) == deliverables(whole) \
        == deliverables(one_shard)


def test_loss_of_the_last_shard_restarts(one_shard):
    inj = FaultInjector(FaultPlan(lose_device=(3, 0)))
    res = stream.stream_grid(**REFERENCE_GRID, **KW, devices=("cpu",),
                             fault_injector=inj)
    assert res.stats["restarts"] == 1.0
    assert res.stats["elastic_replans"] == 0.0
    assert deliverables(res) == deliverables(one_shard)


@pytest.mark.parametrize("name", [p[0] for p in PLANS])
def test_plan_geometry_matches_reference(ref, name):
    _, n_dev, kw = next(p for p in PLANS if p[0] == name)
    plan = stream.plan_stream(**REFERENCE_GRID, **kw,
                              devices=("cpu",) * n_dev)
    want = ref["plans"][name]
    assert (plan.chunk, plan.scan, plan.spec.small_index) == (
        want["chunk"], want["scan"], want["small_index"])
    assert plan.signature == want["signature"]
    assert plan.devices == (torch.device("cpu"),) * n_dev


def test_quantum_error_matches_reference(ref):
    with pytest.raises(ValueError) as e:
        stream.stream_grid(**REFERENCE_GRID, **KW, flat_range=(0, 1000),
                           devices=CPU4)
    assert str(e.value) == ref["quantum_error"]
    assert "x 4 device(s)" in str(e.value)


def test_flat_range_halves_merge_on_four_shards(one_shard):
    n = one_shard.n_configs
    cut = 256 * 4 * 5
    parts = [stream.stream_grid(**REFERENCE_GRID, **KW, devices=CPU4,
                                flat_range=r) for r in ((cut, n), (0, cut))]
    merged = stream.merge_results(parts)
    assert merged.n_devices == 8
    assert deliverables(merged) == deliverables(one_shard)


# ---------------------------------------------------------------------------
# Kill, resume and cross-package checkpoints with four shards
# ---------------------------------------------------------------------------

_KILL = """
import sys
from repro_torch.core import stream
from repro_torch.core.grids import REFERENCE_GRID
from repro_torch.runtime import FaultInjector, FaultPlan
stream.stream_grid(**REFERENCE_GRID, chunk_size=256, top_k=4, track="all",
                   devices=("cpu",) * 4, checkpoint_dir=sys.argv[1],
                   checkpoint_every_steps=1,
                   fault_injector=FaultInjector(FaultPlan(kill_at=24)))
print("UNREACHABLE")
"""


def test_sigkilled_four_shard_child_then_resume(tmp_path, one_shard):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _KILL, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == -signal.SIGKILL, out.stderr[-2000:]
    assert "UNREACHABLE" not in out.stdout
    res = stream.stream_grid(**REFERENCE_GRID, **KW, devices=CPU4,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every_steps=1)
    assert res.n_devices == 4
    assert res.stats["resumed_from_step"] == 24
    assert deliverables(res) == deliverables(one_shard)


EARLY = 256 * 4 * 3      # the flat index an interrupted run stopped after


def _cut_copy(src, dst, upto):
    shutil.copytree(src, dst)
    for d in pathlib.Path(dst).iterdir():
        if d.name.startswith("step_") and int(d.name[5:]) > upto:
            shutil.rmtree(d)
    return str(dst)


@pytest.fixture(scope="module")
def four_device_checkpoints(tmp_path_factory):
    """Four-device checkpoints written by each package (every dispatch,
    all kept); the reference resumes the port's, cut back to ``EARLY``."""
    root = tmp_path_factory.mktemp("ckpt4")
    ours = str(root / "port")
    res = stream.stream_grid(**REFERENCE_GRID, **KW, devices=CPU4,
                             checkpoint_dir=ours, checkpoint_every_steps=1,
                             checkpoint_keep=10**6)
    ref = run("checkpoint", host_devices=4, n_devices=4, grid=REFERENCE_GRID,
              kw=KW, write=str(root / "reference"), read=ours,
              resume={"early": EARLY})
    return {"port": ours, "reference": str(root / "reference"), "ref": ref,
            "res": res, "root": root}


def test_four_device_signatures_match(four_device_checkpoints):
    c = four_device_checkpoints
    plan = stream.plan_stream(**REFERENCE_GRID, **KW, devices=CPU4)
    assert plan.signature == c["ref"]["signature"]
    assert sorted(c["ref"]["read"]) == sorted(c["ref"]["written"])


@pytest.mark.parametrize("shards", [4, 1])
def test_port_resumes_reference_four_device_checkpoints(
        four_device_checkpoints, one_shard, shards, tmp_path):
    c = four_device_checkpoints
    root = _cut_copy(c["reference"], tmp_path / "c", EARLY)
    kw = dict(KW) if shards == 4 else dict(KW, scan_chunks=1)
    res = stream.stream_grid(**REFERENCE_GRID, **kw,
                             devices=("cpu",) * shards, checkpoint_dir=root)
    assert res.stats["resumed_from_step"] == EARLY // 256
    assert deliverables(res) == deliverables(one_shard)
    want = c["ref"]["summary"]
    assert res.min_idx == want["min_idx"]
    assert np.array_equal(res.front_indices, np.sort(want["front_idx"]))


def test_reference_resumes_port_four_device_checkpoints(
        four_device_checkpoints, one_shard):
    c = four_device_checkpoints
    got = c["ref"]["resumed"]["early"]
    assert got["stats"]["resumed_from_step"] == EARLY // 256
    assert got["min_idx"] == one_shard.min_idx
    assert np.array_equal(got["topk_idx"], one_shard.topk_idx)
    assert np.array_equal(got["front_idx"],
                          one_shard.pareto_front().indices)
    assert_close(got["front_val"], one_shard.pareto_front().values)


# ---------------------------------------------------------------------------
# Gates and the step cache
# ---------------------------------------------------------------------------


def test_cuda_backend_refuses_several_devices():
    msg = "does not support the multi-device path"
    with pytest.raises(ValueError, match=msg):
        stream.stream_grid(**REFERENCE_GRID, devices=("cpu", "cpu"),
                           backend="cuda")
    plan = stream.plan_stream(**REFERENCE_GRID, device="cpu")
    with pytest.raises(ValueError, match=msg):
        B.build_step(plan.spec, "cuda", "cpu", 1, devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match=msg):
        B.cached_step(plan.spec, "cuda", 1, "cpu", devices=("cpu", "cpu"))
    assert not B.get_backend("cuda").supports_multi_device
    assert B.get_backend("torch").supports_multi_device


def test_automatic_device_list_is_one_cpu_shard(one_shard):
    plan = stream.plan_stream(**REFERENCE_GRID, device="cpu")
    assert plan.devices == (plan.device,)
    assert one_shard.n_devices == 1
    assert stream.result_to_json(_run("four"))["n_devices"] == 4


def test_step_cache_keys_shards_by_position():
    plan = stream.plan_stream(**REFERENCE_GRID, **KW, devices=CPU4)
    a = B.cached_step(plan.spec, plan.backend, plan.scan, "cpu", CPU4)
    assert isinstance(a, B.ShardedStep) and len(a.steps) == 4
    assert len({id(st) for st in a.steps}) == 4
    a.busy = False
    b = B.cached_step(plan.spec, plan.backend, plan.scan, "cpu", CPU4)
    assert all(x is y for x, y in zip(a.steps, b.steps))
    single = B.cached_step(plan.spec, plan.backend, plan.scan, "cpu")
    assert single is not b.steps[0]
    b.busy = single.busy = False
