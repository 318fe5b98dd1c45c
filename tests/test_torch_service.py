"""The port's sweep service on the CPU: admission control, fusion,
deadlines, crash recovery — the reference's ``tests/test_service.py``
case for case on ``repro_torch.core.service`` (``device="cpu"``), and
the port held to the reference.

Everything the service adds on top of the streaming executor must be
exactness-preserving: a served request returns bitwise what a solo
``stream_grid`` call of the port returns, fusion slices each member's
deliverables exactly out of the stacked dispatch, a deadline or cancel
yields the executor's consistent prefix snapshot, and a SIGKILLed server
restarted over the same spool resumes to bitwise-identical results.
Against the reference's ``SweepService`` (run in the ``_jax_reference``
child): served and fused results with argmin, counts, top-k and front
index sets exact and values within 1e-12 relative; ``to_json`` and the
plan signature equal; and a spool the reference journaled is recovered
by the port.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _jax_reference import assert_matches_reference, deliverables, run
from repro_torch.core import pareto, stream, sweep
from repro_torch.core.service import (CancelledError, ServiceClosedError,
                                      SweepRequest, SweepService, _fusable,
                                      _fused_request, plan_kwargs)
from repro_torch.runtime import (AdmissionQueue, BackpressureError,
                                 Deadline, FaultInjector, FaultPlan)

# The reference test's grid (1,632 configs with the default cut axis);
# chunk 97 does not divide it, exercising the ragged tail through the
# service path.
GRID = dict(
    agg_nodes=("7nm", "16nm"),
    sensor_nodes=("7nm", "16nm"),
    detnet_fps=(10.0, 20.0, 30.0),
    keynet_fps=(30.0, 45.0),
    num_cameras=(2.0, 4.0),
)
CHUNK = 97
TOP_K = 4
OBJS = pareto.DEFAULT_OBJECTIVES
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _kw(**kw):
    kw.setdefault("grid", GRID)
    kw.setdefault("track", "all")
    kw.setdefault("chunk_size", CHUNK)
    kw.setdefault("top_k", TOP_K)
    return kw


def _request(**kw):
    return SweepRequest(**_kw(**kw))


def _service(**kw):
    return SweepService(device="cpu", **kw)


#: Requests served by both packages' services, alone.
REQUESTS = {
    "full": _kw(),
    "cons_max_hist": _kw(objectives=("avg_power", "sensor_macs_per_s"),
                         maximize=("sensor_macs_per_s",),
                         constraints={"latency": 0.0283}, hist_bins=8,
                         scan_chunks=2),
}
#: Three compatible requests, fused into one dispatch by both.
FUSED = {
    "head": _kw(),
    "top2": _kw(top_k=2),
    "one_obj": _kw(objectives=list(OBJS[:1]), need_front=False,
                   track=None),
}


@pytest.fixture(scope="module")
def dense():
    return sweep.evaluate_grid(**GRID, device="cpu")


@pytest.fixture(scope="module")
def solo():
    """The port's solo run every served request must reproduce."""
    return stream.stream_grid(**GRID, track="all", chunk_size=CHUNK,
                              top_k=TOP_K, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return run("service", requests=REQUESTS, fused=FUSED)


def _assert_bitwise(res, want):
    """Bitwise equality on every deliverable of two stream results."""
    assert deliverables(res) == deliverables(want)


# ---------------------------------------------------------------------------
# Admission primitives
# ---------------------------------------------------------------------------


class TestDeadline:
    def test_none_never_expires(self):
        d = Deadline.after(None)
        assert not d.expired()
        assert d.remaining_s() is None

    def test_expiry_and_remaining(self):
        d = Deadline.after(0.0)
        assert d.expired()
        assert d.remaining_s() <= 0.0
        far = Deadline.after(60.0)
        assert not far.expired()
        assert 0.0 < far.remaining_s() <= 60.0

    def test_earliest_picks_tightest(self):
        a, b = Deadline.after(10.0), Deadline.after(60.0)
        assert Deadline.earliest(a, b, Deadline.after(None)).at == a.at
        assert Deadline.earliest(Deadline.after(None)).at is None
        assert Deadline.earliest().at is None


class TestAdmissionQueue:
    def test_capacity_validated(self):
        with pytest.raises(ValueError):
            AdmissionQueue(0)

    def test_offer_rejects_at_capacity_with_fields(self):
        q = AdmissionQueue(2)
        q.offer("a")
        q.offer("b")
        with pytest.raises(BackpressureError) as ei:
            q.offer("c")
        assert ei.value.queue_depth == 2
        assert ei.value.capacity == 2
        assert q.depth == 2
        assert q.snapshot() == ["a", "b"]

    def test_take_batch_fifo_and_timeout(self):
        q = AdmissionQueue(4)
        assert q.take_batch(timeout=0.01) == []
        q.offer("a")
        q.offer("b")
        assert q.take_batch(timeout=0.01) == ["a"]
        assert q.take_batch(timeout=0.01) == ["b"]

    def test_take_batch_claims_compatible_followers(self):
        q = AdmissionQueue(8)
        for item in ("a1", "b1", "a2", "a3", "b2"):
            q.offer(item)
        batch = q.take_batch(timeout=0.01,
                             compatible=lambda h, o: o[0] == h[0],
                             max_batch=3)
        assert batch == ["a1", "a2", "a3"]
        assert q.snapshot() == ["b1", "b2"]

    def test_take_batch_respects_max_batch(self):
        q = AdmissionQueue(8)
        for item in ("a1", "a2", "a3"):
            q.offer(item)
        batch = q.take_batch(timeout=0.01,
                             compatible=lambda h, o: True, max_batch=2)
        assert batch == ["a1", "a2"]
        assert q.snapshot() == ["a3"]

    def test_readmit_prepends_and_bypasses_capacity(self):
        q = AdmissionQueue(1)
        q.offer("new")
        q.readmit("recovered")
        assert q.snapshot() == ["recovered", "new"]

    def test_remove(self):
        q = AdmissionQueue(4)
        q.offer("a")
        assert q.remove("a") is True
        assert q.remove("a") is False
        assert q.depth == 0


# ---------------------------------------------------------------------------
# Request validation & fusion rules (pure functions — no executor)
# ---------------------------------------------------------------------------


class TestSweepRequest:
    def test_unknown_grid_axis_rejected(self):
        with pytest.raises(ValueError, match="unknown grid axes"):
            _request(grid={"not_an_axis": (1, 2)}).normalized()

    def test_json_round_trip(self):
        req = _request(constraints={"avg_power": 1.0},
                       deadline_s=2.5).normalized()
        clone = SweepRequest.from_json(
            json.loads(json.dumps(req.to_json())))
        assert clone == req

    def test_deadlines_never_fuse(self):
        a, b = _request(), _request(deadline_s=5.0)
        assert not _fusable(a, b)
        assert not _fusable(b, a)
        assert _fusable(a, _request())

    def test_sense_conflict_never_fuses(self):
        a = _request(objectives=OBJS, maximize=())
        b = _request(objectives=OBJS, maximize=(OBJS[0],))
        assert not _fusable(a, b)

    def test_front_containment_rules(self):
        head = _request(objectives=OBJS)
        sub = _request(objectives=OBJS[:1], need_front=False)
        assert _fusable(head, sub)
        assert not _fusable(head, _request(objectives=OBJS[:1]))
        assert not _fusable(_request(need_front=False), _request())

    def test_fused_request_covers_members(self):
        a = _request(objectives=OBJS[:2], track=("detnet_power",),
                     top_k=2)
        b = _request(objectives=OBJS[:1], need_front=False, top_k=6)
        fused = _fused_request([a, b])
        assert fused.objectives == tuple(OBJS[:2])
        assert fused.top_k == 6
        assert fused.need_front
        assert fused.deadline_s is None


# ---------------------------------------------------------------------------
# The service itself
# ---------------------------------------------------------------------------


class TestServiceBasics:
    def test_served_request_bitwise_parity(self, solo):
        with _service() as svc:
            t = svc.submit(_request())
            res = t.result(timeout=600)
        assert not res.partial
        assert res.stats["fraction_complete"] == 1.0
        assert t.state == "done" and t.done()
        _assert_bitwise(res, solo)

    def test_plan_and_step_cache_hit_on_resubmit(self, solo):
        with _service() as svc:
            r1 = svc.submit(_request()).result(timeout=600)
            r2 = svc.submit(_request()).result(timeout=600)
            health = svc.health()
        _assert_bitwise(r1, r2)
        _assert_bitwise(r1, solo)
        assert health["plan_cache"]["misses"] == 1
        assert health["plan_cache"]["hits"] == 1
        assert health["step_cache"]["hits"] >= 1

    def test_health_surface_is_jsonable(self):
        with _service(capacity=3) as svc:
            svc.submit(_request()).result(timeout=600)
            health = svc.health()
        json.dumps(health)
        assert health["capacity"] == 3
        assert health["queue_depth"] == 0
        assert health["counters"]["admitted"] == 1
        assert health["counters"]["completed"] == 1
        assert health["counters"]["executions"] == 1
        for key in ("retries", "restarts", "elastic_replans",
                    "stragglers", "deadline_expired"):
            assert key in health["counters"], key
        tid = next(iter(health["requests"]))
        assert health["requests"][tid]["state"] == "done"
        assert health["requests"][tid]["progress"] == 1.0

    def test_submit_after_close_raises(self):
        svc = _service()
        svc.close()
        with pytest.raises(RuntimeError, match="shut down"):
            svc.submit(_request())

    def test_malformed_request_rejected_before_admission(self):
        with _service() as svc:
            with pytest.raises(ValueError):
                svc.submit(_request(grid={"bogus_axis": (1,)}))
            assert svc.health()["counters"]["admitted"] == 0


class TestFusion:
    def test_compatible_requests_fuse_to_one_dispatch(self, solo, dense):
        with _service(capacity=8) as svc:
            svc.pause()
            ta = svc.submit(_request())
            tb = svc.submit(_request(top_k=2))
            tc = svc.submit(_request(objectives=OBJS[:1],
                                     need_front=False, track=None))
            svc.resume()
            ra = ta.result(timeout=600)
            rb = tb.result(timeout=600)
            rc = tc.result(timeout=600)
            counters = svc.health()["counters"]
        assert counters["executions"] == 1
        assert counters["fused_requests"] == 3
        for r in (ra, rb, rc):
            assert r.stats["fused_members"] == 3.0
        _assert_bitwise(ra, solo)
        assert np.array_equal(rb.topk_idx, solo.topk_idx[:, :2])
        assert np.array_equal(rb.topk_val, solo.topk_val[:, :2])
        assert np.array_equal(rb.front_indices, solo.front_indices)
        assert rc.objectives == tuple(OBJS[:1])
        assert rc.front_indices.size == 0
        obj = OBJS[0]
        assert rc.argmin(obj) == dense.argmin(obj)
        assert rc.top_k(obj) == dense.top_k(obj, TOP_K)

    def test_incompatible_requests_do_not_fuse(self):
        with _service(capacity=8) as svc:
            svc.pause()
            ta = svc.submit(_request())
            tb = svc.submit(_request(maximize=(OBJS[0],),
                                     need_front=False))
            svc.resume()
            ta.result(timeout=600)
            tb.result(timeout=600)
            counters = svc.health()["counters"]
        assert counters["executions"] == 2
        assert counters["fused_requests"] == 0


class TestBackpressure:
    def test_reject_at_capacity_without_dropping_work(self, solo):
        with _service(capacity=2) as svc:
            svc.pause()
            ta = svc.submit(_request())
            tb = svc.submit(_request(top_k=2))
            with pytest.raises(BackpressureError) as ei:
                svc.submit(_request())
            assert ei.value.queue_depth == 2
            assert ei.value.capacity == 2
            counters = svc.health()["counters"]
            assert counters["rejected"] == 1
            assert counters["admitted"] == 2
            svc.resume()
            ra = ta.result(timeout=600)
            tb.result(timeout=600)
        _assert_bitwise(ra, solo)


class TestIdempotentSubmit:
    def test_same_client_id_returns_same_ticket(self, solo):
        with _service() as svc:
            t1 = svc.submit(_request(), client_id="cid-1")
            t2 = svc.submit(_request(), client_id="cid-1")
            assert t1 is t2
            res = t2.result(timeout=600)
            counters = svc.health()["counters"]
        _assert_bitwise(res, solo)
        assert counters["deduped"] == 1
        assert counters["admitted"] == 1
        assert counters["executions"] == 1

    def test_same_client_id_different_request_rejected(self):
        with _service() as svc:
            svc.pause()
            svc.submit(_request(), client_id="cid-2")
            with pytest.raises(ValueError, match="already used"):
                svc.submit(_request(top_k=TOP_K + 1), client_id="cid-2")

    def test_rejected_submit_does_not_burn_the_client_id(self):
        with _service(capacity=1) as svc:
            svc.pause()
            svc.submit(_request())
            with pytest.raises(BackpressureError):
                svc.submit(_request(top_k=2), client_id="cid-3")
            svc.resume()
            svc.tickets()[0].result(timeout=600)
            t = svc.submit(_request(top_k=2), client_id="cid-3")
            t.result(timeout=600)

    def test_finished_request_recovered_with_result(self, tmp_path,
                                                    solo):
        spool = str(tmp_path / "spool")
        with _service(spool_dir=spool) as svc:
            first = svc.submit(_request(), client_id="cid-4")
            r1 = first.result(timeout=600)
        with _service(spool_dir=spool) as svc2:
            counters = svc2.health()["counters"]
            assert counters["recovered_finished"] == 1
            t = svc2.submit(_request(), client_id="cid-4")
            assert t.done() and t.state == "done"
            r2 = t.result(timeout=10)
            assert svc2.health()["counters"]["executions"] == 0
        _assert_bitwise(r1, solo)
        _assert_bitwise(r2, solo)

    def test_tenant_and_priority_round_trip(self):
        req = _request(tenant="alice", priority=3).normalized()
        clone = SweepRequest.from_json(
            json.loads(json.dumps(req.to_json())))
        assert clone.tenant == "alice" and clone.priority == 3
        assert clone == req


class TestServiceShutdown:
    def test_queued_ticket_fails_fast_when_service_closes(self):
        svc = _service()
        svc.pause()
        t = svc.submit(_request())
        svc.close(drain=False)
        with pytest.raises(ServiceClosedError, match="service closed"):
            t.result(timeout=30)
        assert t.done()

    def test_closed_queued_ticket_resumes_on_restarted_spool(self,
                                                             tmp_path,
                                                             solo):
        spool = str(tmp_path / "spool")
        svc = _service(spool_dir=spool)
        svc.pause()
        t = svc.submit(_request())
        svc.close(drain=False)
        with pytest.raises(ServiceClosedError):
            t.result(timeout=30)
        with _service(spool_dir=spool) as svc2:
            assert svc2.health()["counters"]["recovered"] == 1
            res = svc2.tickets()[0].result(timeout=600)
        _assert_bitwise(res, solo)


class TestDeadlinesAndCancel:
    def test_deadline_returns_consistent_partial_snapshot(self, dense):
        # A 2 s straggle injected at chunk 1 makes the 0.8 s deadline
        # lapse mid-sweep however fast the host.
        inj = FaultInjector(FaultPlan(straggle={1: 2.0}))
        with _service(fault_injector=inj) as svc:
            t = svc.submit(_request(deadline_s=0.8))
            res = t.result(timeout=600)
            counters = svc.health()["counters"]
        assert res.partial
        frac = res.stats["fraction_complete"]
        assert 0.0 < frac < 1.0
        assert counters["deadline_expired"] == 1
        assert t.state == "done"
        # Prefix consistency: the exact reduction over the first `base`
        # flat configs, and bitwise the flat_range run of that prefix.
        base = round(frac * dense.data[OBJS[0]].size)
        for field in OBJS:
            prefix = np.asarray(dense.data[field]).ravel()[:base]
            assert res.min_val[field] == float(np.nanmin(prefix)), field
            assert res.min_idx[field] == int(np.nanargmin(prefix)), field
            assert res.finite_counts[field] == \
                int(np.isfinite(prefix).sum()), field
        ranged = stream.stream_grid(**GRID, track="all", chunk_size=CHUNK,
                                    top_k=TOP_K, flat_range=(0, base),
                                    device="cpu")
        _assert_bitwise(res, ranged)

    def test_cancel_before_execution(self):
        with _service() as svc:
            svc.pause()
            t = svc.submit(_request())
            t.cancel()
            svc.resume()
            assert t.done()
            assert t.state == "cancelled"
            with pytest.raises(CancelledError):
                t.result(timeout=10)

    def test_cancel_mid_run_yields_partial(self):
        inj = FaultInjector(FaultPlan(straggle={1: 1.0}))
        with _service(fault_injector=inj) as svc:
            t = svc.submit(_request())
            deadline = time.monotonic() + 120
            while t.progress == 0.0 and time.monotonic() < deadline:
                time.sleep(0.01)
            t.cancel()
            res = t.result(timeout=600)
            counters = svc.health()["counters"]
        assert t.state == "cancelled"
        assert res.partial
        assert 0.0 < res.stats["fraction_complete"] < 1.0
        assert counters["cancelled"] == 1


class TestServiceCrashRecovery:
    """SIGKILL the server mid-request; a fresh service over the same
    spool must re-admit the journaled request, resume from the newest
    checkpoint, and deliver the bitwise solo-run answer."""

    _COMMON = """
import sys
import numpy as np
from repro_torch.core import stream
from repro_torch.core.service import SweepService, SweepRequest
GRID = dict(agg_nodes=("7nm","16nm"), sensor_nodes=("7nm","16nm"),
            detnet_fps=(10.,20.,30.), keynet_fps=(30.,45.),
            num_cameras=(2.,4.))
REQ = SweepRequest(grid=GRID, track="all", chunk_size=97, top_k=4)
"""

    KILL = _COMMON + """
from repro_torch.runtime import FaultInjector, FaultPlan
inj = FaultInjector(FaultPlan(kill_at=4))
svc = SweepService(spool_dir=sys.argv[1], capacity=4, device="cpu",
                   checkpoint_every_steps=1, fault_injector=inj)
svc.submit(REQ).result(timeout=600)
print("UNREACHABLE")
"""

    RESUME = _COMMON + """
import json
svc = SweepService(spool_dir=sys.argv[1], capacity=4, device="cpu",
                   checkpoint_every_steps=1)
ts = svc.tickets()
assert len(ts) == 1, [t.id for t in ts]
assert svc.health()["counters"]["recovered"] == 1
res = ts[0].result(timeout=600)
svc.close()
assert not res.partial
assert res.stats["resumed_from_step"] > 0, res.stats
ref = stream.stream_grid(**GRID, track="all", chunk_size=97, top_k=4,
                         device="cpu")
assert res.min_val == ref.min_val and res.min_idx == ref.min_idx
assert res.finite_counts == ref.finite_counts
assert np.array_equal(res.topk_idx, ref.topk_idx)
assert np.array_equal(res.topk_val, ref.topk_val)
assert np.array_equal(res.front_indices, ref.front_indices)
assert np.array_equal(res.front_values, ref.front_values)
print(json.dumps({"resumed_from_step": res.stats["resumed_from_step"],
                  "ok": True}))
"""

    @staticmethod
    def _run(code: str, spool: str) -> subprocess.CompletedProcess:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [SRC] + env.get("PYTHONPATH", "").split(os.pathsep))
        return subprocess.run([sys.executable, "-c", code, spool],
                              env=env, capture_output=True, text=True,
                              timeout=600)

    def test_sigkill_restart_resumes_bitwise(self, tmp_path):
        spool = str(tmp_path / "spool")
        out1 = self._run(self.KILL, spool)
        assert out1.returncode == -signal.SIGKILL, \
            (out1.returncode, out1.stderr[-2000:])
        assert "UNREACHABLE" not in out1.stdout
        out2 = self._run(self.RESUME, spool)
        assert out2.returncode == 0, out2.stderr[-2000:]
        payload = json.loads(out2.stdout.strip().splitlines()[-1])
        assert payload["ok"] is True
        assert payload["resumed_from_step"] > 0


class TestCLI:
    def test_module_entry_point_serves_requests(self, tmp_path):
        """``python -m repro_torch.service --device cpu`` over a request
        file: one JSON summary per request plus a health snapshot."""
        reqfile = tmp_path / "reqs.jsonl"
        reqfile.write_text(json.dumps(
            _request(track=None).to_json()) + "\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [SRC] + env.get("PYTHONPATH", "").split(os.pathsep))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.service",
             "--device", "cpu", "--spool", str(tmp_path / "spool"),
             "--requests", str(reqfile), "--timeout-s", "600"],
            env=env, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
        assert lines[0]["state"] == "done"
        assert lines[0]["fraction_complete"] == 1.0
        assert "argmin" in lines[0]
        assert lines[-1]["health"]["counters"]["completed"] == 1


# ---------------------------------------------------------------------------
# The port against the reference's service
# ---------------------------------------------------------------------------


class TestAgainstReference:
    @pytest.mark.parametrize("name", sorted(REQUESTS))
    def test_served_matches_reference(self, ref, name):
        want = ref["served"][name]
        with _service() as svc:
            res = svc.submit(SweepRequest(**REQUESTS[name])).result(
                timeout=600)
        kw = plan_kwargs(SweepRequest(**REQUESTS[name]).normalized())
        _assert_bitwise(res, stream.stream_grid(**kw, device="cpu"))
        assert_matches_reference(res, want)
        assert stream.result_to_json(res).keys() == want["json"].keys()

    @pytest.mark.parametrize("name", sorted(REQUESTS))
    def test_request_json_and_signature_match_reference(self, ref, name):
        req = SweepRequest(**REQUESTS[name])
        assert req.to_json() == ref["json"][name]
        plan = stream.plan_stream(**plan_kwargs(req.normalized()),
                                  device="cpu")
        assert plan.signature == ref["signature"][name]

    def test_fused_members_match_reference(self, ref):
        with _service(capacity=8) as svc:
            svc.pause()
            tickets = {n: svc.submit(SweepRequest(**kw))
                       for n, kw in FUSED.items()}
            svc.resume()
            got = {n: t.result(timeout=600) for n, t in tickets.items()}
            assert svc.counters["executions"] == 1
        assert ref["fused_executions"] == 1
        for n, res in got.items():
            assert res.stats["fused_members"] == 3.0
            assert_matches_reference(res, ref["fused"][n])

    def test_service_plans_one_shard_on_its_device(self):
        with _service() as svc:
            assert svc.device == torch.device("cpu")
            plan = svc._plan_for(_request().normalized())
        assert plan.devices == (torch.device("cpu"),)


def test_recovers_a_spool_the_reference_wrote(tmp_path):
    """The reference's service journals a finished and a queued request;
    the port's service over that spool recovers both: the finished one
    with the reference's journaled result (its client id dedupes onto
    it), the queued one executed here, bitwise the port's solo run and
    within 1e-12 of the reference's."""
    spool = tmp_path / "spool"
    done_kw = _kw(top_k=3)
    queued_kw = _kw(objectives=["avg_power", "latency"],
                    constraints={"latency": 0.0283}, scan_chunks=2)
    want = run("spool", spool=str(spool), done=done_kw, queued=queued_kw)
    queued = SweepRequest(**queued_kw)
    assert queued.to_json() == want["queued_json"]
    kw = plan_kwargs(queued.normalized())
    assert stream.plan_stream(**kw, device="cpu").signature == \
        want["queued_signature"]
    with _service(spool_dir=str(spool)) as svc:
        counters = svc.health()["counters"]
        assert counters["recovered"] == 1
        assert counters["recovered_finished"] == 1
        t_done = svc.submit(SweepRequest(**done_kw), client_id="ref-done")
        assert t_done.done() and t_done.state == "done"
        t_queued = svc.submit(queued, client_id="ref-queued")
        res = t_queued.result(timeout=600)
        assert svc.health()["counters"]["executions"] == 1
    assert_matches_reference(t_done.result(timeout=10), want["done"])
    assert_matches_reference(res, want["queued_solo"])
    _assert_bitwise(res, stream.stream_grid(**kw, device="cpu"))
