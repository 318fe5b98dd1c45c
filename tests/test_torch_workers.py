"""The port's worker pool on the CPU: lease board transitions, range
parity, kill-reclaim — the reference's ``tests/test_workers.py`` case
for case on ``repro_torch.runtime.workers`` (``device="cpu"``), and the
port's fold held to the reference.

The scale-out path must add no numeric semantics: a job drained by any
number of worker processes folds to a result bitwise equal to one solo
``stream_grid`` call of the port.  The lease board is the only
coordination state, so these tests drive the board directly, drain a
job in process, run it through the pooled service, and SIGKILL a live
worker mid-lease.  Against the reference (the ``_jax_reference`` child:
its ``dispatch_job`` + ``worker_loop(once=True)`` in process): the same
lease ranges and signature, and the fold's argmin, counts, top-k and
front index sets exact, values within 1e-12 relative.
"""

import json
import os
import signal
import time

import pytest
import torch

from _jax_reference import assert_matches_reference, deliverables, run
from repro_torch.core import stream
from repro_torch.core.service import SweepRequest, SweepService
from repro_torch.runtime import workers as wk

# 2 * 2 * 12 * 2 * 2 = 192 configs; chunk 31 with scan_chunks=1 gives a
# 31-config lease quantum -> 7 dispatch steps, so a multi-lease board
# has interior boundaries that must respect flat_range alignment.
GRID = dict(
    agg_nodes=("7nm", "16nm"),
    sensor_nodes=("7nm", "16nm"),
    detnet_fps=tuple(float(f) for f in range(5, 65, 5)),
    keynet_fps=(30.0, 45.0),
    num_cameras=(2.0, 4.0),
)
CHUNK = 31
TOP_K = 4


def _kw(**kw):
    kw.setdefault("grid", GRID)
    kw.setdefault("track", "all")
    kw.setdefault("chunk_size", CHUNK)
    kw.setdefault("scan_chunks", 1)
    kw.setdefault("top_k", TOP_K)
    return kw


def _request(**kw):
    return SweepRequest(**_kw(**kw))


def _dispatch(spool, req=None, **kw):
    return wk.dispatch_job(str(spool), req or _request(), device="cpu",
                           **kw)


@pytest.fixture(scope="module")
def solo():
    return stream.stream_grid(**GRID, track="all", chunk_size=CHUNK,
                              scan_chunks=1, top_k=TOP_K, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return run("worker_drain", request=_kw(), n_leases=5)


def _assert_bitwise(res, want):
    assert deliverables(res) == deliverables(want)


# ---------------------------------------------------------------------------
# Lease board state machine (no execution)
# ---------------------------------------------------------------------------


class TestLeaseBoard:
    def _board(self, tmp_path, **kw):
        handle = _dispatch(tmp_path, **kw)
        return handle, handle.board

    def test_dispatch_tiles_the_flat_space_aligned(self, tmp_path):
        handle, board = self._board(tmp_path, n_leases=5)
        doc = board.read()
        leases = doc["leases"]
        assert leases[0]["start"] == 0
        assert leases[-1]["stop"] == handle.n_total
        q = doc["quantum"]
        for prev, cur in zip(leases, leases[1:]):
            assert prev["stop"] == cur["start"]
            assert cur["start"] % q == 0
        assert all(ls["state"] == "free" for ls in leases)

    def test_dispatch_is_idempotent_by_signature(self, tmp_path):
        h1, board = self._board(tmp_path, n_leases=3)
        assert board.claim("w-a", ttl=60.0) is not None
        h2 = _dispatch(tmp_path, n_leases=3)
        assert h2.job_dir == h1.job_dir
        assert h2.board.read()["leases"][0]["state"] == "leased"

    def test_claim_heartbeat_steal(self, tmp_path):
        _, board = self._board(tmp_path, n_leases=2)
        lease = board.claim("w-a", ttl=0.05)
        assert lease["i"] == 0 and lease["attempt"] == 1
        assert board.heartbeat(0, "w-a", 0.25)
        time.sleep(0.1)
        stolen = board.claim("w-b", ttl=0.05)
        assert stolen["i"] == 0 and stolen["attempt"] == 2
        assert not board.heartbeat(0, "w-a")
        board.fail(0, "w-a", "boom")
        assert board.read()["leases"][0]["state"] == "leased"
        assert board.read()["leases"][0]["wid"] == "w-b"

    def test_fail_frees_then_attempt_cap_fails_terminally(self, tmp_path):
        _, board = self._board(tmp_path, n_leases=1, max_attempts=2)
        lease = board.claim("w-a", ttl=60.0)
        board.fail(lease["i"], "w-a", "transient")
        assert board.read()["leases"][0]["state"] == "free"
        lease = board.claim("w-a", ttl=60.0)
        assert lease["attempt"] == 2
        board.fail(lease["i"], "w-a", "again")
        assert board.read()["leases"][0]["state"] == "failed"
        assert board.claim("w-a", ttl=60.0) is None
        st = board.poll()
        assert not st["done"] and len(st["failed"]) == 1
        assert "again" in st["failed"][0]["error"]

    def test_done_wins_over_steal(self, tmp_path):
        _, board = self._board(tmp_path, n_leases=1)
        board.claim("w-a", ttl=0.05)
        time.sleep(0.1)
        board.claim("w-b", ttl=0.05)
        board.complete(0, "w-a", {"fake": "part"})
        doc = board.read()
        assert doc["leases"][0]["state"] == "done"
        with open(board.part_path(0)) as f:
            assert json.load(f) == {"fake": "part"}

    def test_cancel_flag_round_trip(self, tmp_path):
        handle, board = self._board(tmp_path)
        assert not board.cancelled()
        handle.cancel()
        assert board.cancelled()
        _dispatch(tmp_path)
        assert not board.cancelled()


# ---------------------------------------------------------------------------
# In-process drain: parity and checkpoint-resume on reclaim
# ---------------------------------------------------------------------------


class TestWorkerDrain:
    def test_once_drain_is_bitwise_exact(self, tmp_path, solo):
        handle = _dispatch(tmp_path, n_leases=5)
        assert wk.worker_loop(str(tmp_path), wid="w-test", once=True,
                              device="cpu") == 0
        st = handle.poll()
        assert st["done"] and st["fraction"] == 1.0
        res = handle.result()
        _assert_bitwise(res, solo)
        assert res.stats["n_parts"] == 5.0
        snap = handle.snapshot()
        assert snap["fraction_complete"] == 1.0
        assert snap["best"] is not None

    def test_reclaim_resumes_from_carry_snapshot(self, tmp_path, solo):
        """A lease abandoned mid-range (owner died after checkpointing)
        is reclaimed and resumed — the finished prefix is not recomputed
        — and the fold is still bitwise exact."""
        handle = _dispatch(tmp_path, n_leases=2, checkpoint_every_steps=1)
        board = handle.board
        lease = board.claim("w-dead", ttl=0.05)
        stops = [0]

        def stop_after_two():
            stops[0] += 1
            return stops[0] > 2

        part = stream.stream_grid(
            plan=handle.plan,
            flat_range=(lease["start"], lease["stop"]),
            checkpoint_dir=board.ckpt_dir(lease["i"]),
            checkpoint_every_steps=1,
            should_stop=stop_after_two)
        assert part.partial
        assert os.listdir(board.ckpt_dir(lease["i"]))
        time.sleep(0.1)
        reclaimed = board.claim("w-heir", ttl=0.05)
        assert reclaimed["i"] == lease["i"]
        assert reclaimed["attempt"] == 2
        assert wk.run_lease(board, reclaimed, "w-heir", ttl=60.0,
                            device="cpu")
        with open(board.part_path(reclaimed["i"])) as f:
            stats = json.load(f)["stats"]
        assert stats["resumed_from_step"] > 0
        assert wk.worker_loop(str(tmp_path), wid="w-rest", once=True,
                              device="cpu") == 0
        _assert_bitwise(handle.result(), solo)

    def test_drain_matches_the_reference_drain(self, tmp_path, ref, solo):
        """The same job drained by both packages' workers: the same
        signature, chunk geometry and lease ranges, and the fold within
        1e-12 of the reference's (indices exact)."""
        handle = _dispatch(tmp_path, n_leases=5)
        assert wk.worker_loop(str(tmp_path), once=True, device="cpu") == 0
        res = handle.result()
        job = handle.board.job()
        assert ref["rc"] == 0
        assert handle.signature == ref["signature"]
        assert (job["chunk"], job["scan"]) == (ref["chunk"], ref["scan"])
        assert [(ls["start"], ls["stop"])
                for ls in handle.board.read()["leases"]] == \
            [tuple(x) for x in ref["leases"]]
        assert res.stats["n_parts"] == ref["n_parts"]
        assert_matches_reference(res, ref)
        _assert_bitwise(res, solo)

    def test_rebuilt_signature_mismatch_fails_the_lease(self, tmp_path):
        """A worker whose rebuilt plan differs from the job's (here: the
        pinned chunk rewritten) fails every attempt loudly, never runs
        another plan."""
        handle = _dispatch(tmp_path, n_leases=1, max_attempts=2)
        job = handle.board.job()
        job["chunk"] = CHUNK + 1
        with open(handle.board.job_path, "w") as f:
            json.dump(job, f)
        assert wk.worker_loop(str(tmp_path), wid="w-x", once=True,
                              device="cpu") == 0
        st = handle.poll()
        assert not st["done"] and len(st["failed"]) == 1
        assert "signature" in st["failed"][0]["error"]
        assert not os.path.exists(handle.board.part_path(0))


# ---------------------------------------------------------------------------
# Pooled service path
# ---------------------------------------------------------------------------


class TestPooledService:
    def test_service_dispatches_to_pool_bitwise(self, tmp_path, solo,
                                                ref):
        svc = SweepService(capacity=4, snapshot_every_s=0.0, workers=2,
                           spool_dir=str(tmp_path / "spool"),
                           device="cpu")
        try:
            t = svc.submit(_request())
            res = t.result(timeout=600)
            _assert_bitwise(res, solo)
            assert_matches_reference(res, ref)
            assert res.stats["n_parts"] >= 2.0
            assert svc.counters["pooled_executions"] == 1
            assert svc.health()["workers"]["n"] == 2
            if t.snapshot is not None:
                assert 0.0 <= t.snapshot["fraction_complete"] <= 1.0
                assert t.snapshot["partial"] is True
        finally:
            svc.close()

    def test_deadline_requests_bypass_the_pool(self, tmp_path, solo):
        svc = SweepService(capacity=4, snapshot_every_s=0.0, workers=1,
                           spool_dir=str(tmp_path / "spool"),
                           device="cpu")
        try:
            t = svc.submit(_request(deadline_s=600.0))
            res = t.result(timeout=600)
            _assert_bitwise(res, solo)
            assert svc.counters["pooled_executions"] == 0
        finally:
            svc.close()


# ---------------------------------------------------------------------------
# Chaos: SIGKILL a live worker mid-lease (the reclaim gate)
# ---------------------------------------------------------------------------


class TestWorkerKillReclaim:
    def test_sigkill_one_of_three_workers_reclaims_bitwise(
            self, tmp_path, solo):
        spool = str(tmp_path / "spool")
        os.makedirs(spool)
        handle = _dispatch(spool, n_leases=6, checkpoint_every_steps=1)
        ttl = 2.0
        with wk.WorkerPool(spool, 3, ttl_s=ttl, respawn=False,
                           device="cpu") as pool:
            victim = None
            deadline = time.monotonic() + 300
            while victim is None and time.monotonic() < deadline:
                st = handle.poll()
                if st["done"]:
                    break
                for ls in st["leases"]:
                    if ls["state"] == "leased" \
                            and ls["owner"] in pool.pids():
                        victim = int(ls["owner"])
                        break
                time.sleep(0.02)
            assert victim is not None, "no worker claimed a lease"
            os.kill(victim, signal.SIGKILL)
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                st = handle.poll()
                assert not st["failed"], st["failed"]
                if st["done"]:
                    break
                time.sleep(0.1)
            st = handle.poll()
            assert st["done"], f"job did not drain: {st['states']}"
        assert max(int(ls["attempt"]) for ls in st["leases"]) >= 2
        _assert_bitwise(handle.result(), solo)


def test_pool_and_dispatch_default_to_the_card(tmp_path, monkeypatch):
    """Without ``device=`` the pool, a plan-building dispatch and a
    worker loop take the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: wk.WorkerPool(str(tmp_path), 1),
                 lambda: wk.dispatch_job(str(tmp_path), _request()),
                 lambda: wk.worker_loop(str(tmp_path), once=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
