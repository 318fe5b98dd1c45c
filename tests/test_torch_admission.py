"""Admission queue: deadlines, timeout contracts, concurrency, fairness.

The reference's ``tests/test_admission.py``, case for case, on the
port's copy ``repro_torch.runtime.admission`` — the multi-tenant bounded
queue underneath the sweep service — and a check that the port's copies
of the framework-free serving modules (admission, transport, client) are
the reference's code, statement for statement.  The fairness properties here are
the load-bearing ones: deficit round-robin converges to the weight
share under sustained overload, priority aging bounds starvation, and
per-tenant pending caps shed one greedy tenant without touching the
others.  Everything runs queue-level (plain strings as items), so the
whole module is executor-free and fast.
"""

import threading
import time

import pytest

from repro_torch.runtime import (AdmissionQueue, BackpressureError,
                                 Deadline, TenantPolicy)


# ---------------------------------------------------------------------------
# Deadline edge cases
# ---------------------------------------------------------------------------


class TestDeadlineEdges:
    def test_earliest_all_none(self):
        ds = [Deadline.after(None) for _ in range(3)]
        assert Deadline.earliest(*ds).at is None

    def test_earliest_mixed_ignores_none(self):
        none_d = Deadline.after(None)
        tight = Deadline.after(1.0)
        loose = Deadline.after(100.0)
        assert Deadline.earliest(none_d, loose, tight,
                                 none_d).at == tight.at

    def test_earliest_is_order_independent(self):
        a, b = Deadline.after(5.0), Deadline.after(2.0)
        assert Deadline.earliest(a, b).at == Deadline.earliest(b, a).at

    def test_remaining_goes_negative_once_overdue(self):
        d = Deadline(at=time.monotonic() - 1.0)
        assert d.expired()
        assert d.remaining_s() < 0.0


# ---------------------------------------------------------------------------
# TenantPolicy validation
# ---------------------------------------------------------------------------


class TestTenantPolicy:
    def test_weight_must_be_positive(self):
        with pytest.raises(ValueError, match="weight"):
            TenantPolicy(weight=0.0)
        with pytest.raises(ValueError, match="weight"):
            TenantPolicy(weight=-1.0)

    def test_max_pending_must_be_at_least_one(self):
        with pytest.raises(ValueError, match="max_pending"):
            TenantPolicy(max_pending=0)
        TenantPolicy(max_pending=1)        # boundary is legal

    def test_aging_validated(self):
        with pytest.raises(ValueError, match="aging_s"):
            AdmissionQueue(4, aging_s=0.0)


# ---------------------------------------------------------------------------
# take_batch timeout contract
# ---------------------------------------------------------------------------


class TestTakeBatchTimeout:
    def test_empty_queue_times_out_in_bounded_time(self):
        q = AdmissionQueue(4)
        t0 = time.monotonic()
        assert q.take_batch(timeout=0.05) == []
        elapsed = time.monotonic() - t0
        assert 0.04 <= elapsed < 2.0

    def test_paused_queue_with_items_still_times_out(self):
        # Pause must gate claiming even when the backlog is non-empty:
        # this is the race the service-level pause() depends on (a
        # worker already blocked in take_batch must not claim a
        # post-pause submit).
        q = AdmissionQueue(4)
        q.pause()
        q.offer("a")
        assert q.take_batch(timeout=0.05) == []
        assert q.depth == 1                # item stayed admitted
        q.resume()
        assert q.take_batch(timeout=0.05) == ["a"]

    def test_offer_wakes_blocked_consumer(self):
        q = AdmissionQueue(4)
        got = {}

        def consume():
            got["batch"] = q.take_batch(timeout=5.0)

        th = threading.Thread(target=consume)
        th.start()
        time.sleep(0.05)
        q.offer("late")
        th.join(5.0)
        assert got["batch"] == ["late"]

    def test_resume_wakes_blocked_consumer(self):
        q = AdmissionQueue(4)
        q.offer("a")
        q.pause()
        got = {}

        def consume():
            got["batch"] = q.take_batch(timeout=5.0)

        th = threading.Thread(target=consume)
        th.start()
        time.sleep(0.05)
        q.resume()
        th.join(5.0)
        assert got["batch"] == ["a"]


# ---------------------------------------------------------------------------
# Concurrency: offer / readmit / remove racing a draining consumer
# ---------------------------------------------------------------------------


class TestConcurrentMutation:
    def test_no_item_lost_or_duplicated_under_contention(self):
        """Hammer offer/readmit/remove from many threads against a
        draining consumer; conservation must hold exactly: every item
        is claimed once, removed once, or rejected at the door."""
        q = AdmissionQueue(64)
        n_threads, per_thread = 8, 50
        offered, rejected = [], []
        removed = []
        claimed = []
        stop = threading.Event()
        lock = threading.Lock()

        def producer(tid):
            for i in range(per_thread):
                item = f"t{tid}-{i}"
                try:
                    if i % 10 == 3:
                        q.readmit(item)
                        with lock:
                            offered.append(item)
                    else:
                        q.offer(item)
                        with lock:
                            offered.append(item)
                    if i % 7 == 5 and q.remove(item):
                        with lock:
                            removed.append(item)
                except BackpressureError:
                    with lock:
                        rejected.append(item)

        def consumer():
            while not stop.is_set() or q.depth:
                for item in q.take_batch(timeout=0.01):
                    with lock:
                        claimed.append(item)
                    q.release()

        cons = [threading.Thread(target=consumer) for _ in range(2)]
        prods = [threading.Thread(target=producer, args=(t,))
                 for t in range(n_threads)]
        for th in cons + prods:
            th.start()
        for th in prods:
            th.join(30.0)
        stop.set()
        for th in cons:
            th.join(30.0)
        assert q.depth == 0
        assert len(claimed) == len(set(claimed)), "item claimed twice"
        assert set(claimed) | set(removed) == set(offered)
        assert not (set(claimed) & set(removed))

    def test_remove_of_claimed_item_fails(self):
        q = AdmissionQueue(4)
        q.offer("a")
        assert q.take_batch(timeout=0.1) == ["a"]
        assert q.remove("a") is False


# ---------------------------------------------------------------------------
# Deficit round-robin fairness
# ---------------------------------------------------------------------------


class TestWeightedFairness:
    def test_single_tenant_degenerates_to_fifo(self):
        q = AdmissionQueue(16)
        for i in range(6):
            q.offer(f"i{i}")
        order = [q.take_batch(timeout=0.01)[0] for _ in range(6)]
        assert order == [f"i{i}" for i in range(6)]

    def test_overloaded_tenants_converge_to_weight_share(self):
        """Tenants at weights 1:3 with both backlogs always non-empty:
        claimed work splits 25%/75% within 10% (the fairness gate)."""
        q = AdmissionQueue(4096,
                           tenants={"small": TenantPolicy(weight=1.0),
                                    "big": TenantPolicy(weight=3.0)})
        for i in range(600):
            q.offer(f"s{i}", tenant="small")
            q.offer(f"b{i}", tenant="big")
        counts = {"small": 0, "big": 0}
        for _ in range(400):               # both stay backlogged
            (item,) = q.take_batch(timeout=0.1)
            tenant = "small" if item.startswith("s") else "big"
            counts[tenant] += 1
            q.release(tenant)
        share_big = counts["big"] / 400.0
        assert abs(share_big - 0.75) <= 0.10, counts

    def test_idle_tenant_does_not_hoard_credit(self):
        """A tenant that drains and comes back starts from zero credit:
        it cannot burst past its weight share with banked deficit."""
        q = AdmissionQueue(256, tenants={"a": TenantPolicy(weight=1.0),
                                         "b": TenantPolicy(weight=1.0)})
        q.offer("a0", tenant="a")
        assert q.take_batch(timeout=0.1) == ["a0"]   # a drains, leaves
        q.release("a")
        for i in range(40):
            q.offer(f"a{i + 1}", tenant="a")
            q.offer(f"b{i}", tenant="b")
        counts = {"a": 0, "b": 0}
        for _ in range(40):
            (item,) = q.take_batch(timeout=0.1)
            counts[item[0]] += 1
            q.release(item[0])
        assert abs(counts["a"] - counts["b"]) <= 4, counts


# ---------------------------------------------------------------------------
# Priority classes with aging
# ---------------------------------------------------------------------------


class TestPriorityAging:
    def test_higher_priority_claims_first_within_tenant(self):
        q = AdmissionQueue(8)
        q.offer("low", priority=0)
        q.offer("high", priority=5)
        q.offer("mid", priority=2)
        order = [q.take_batch(timeout=0.01)[0] for _ in range(3)]
        assert order == ["high", "mid", "low"]

    def test_same_class_serves_fifo(self):
        q = AdmissionQueue(8)
        for i in range(4):
            q.offer(f"p{i}", priority=1)
        order = [q.take_batch(timeout=0.01)[0] for _ in range(4)]
        assert order == [f"p{i}" for i in range(4)]

    def test_starved_request_ages_past_fresh_high_priority(self):
        """A low-priority request gains one class per aging_s waited,
        so it eventually outranks fresh high-priority arrivals — the
        no-starvation gate."""
        q = AdmissionQueue(8, aging_s=0.02)
        q.offer("starved", priority=0)
        time.sleep(0.09)                   # ages ≥ 4 classes
        q.offer("fresh-high", priority=2)
        assert q.take_batch(timeout=0.1) == ["starved"]

    def test_without_aging_window_high_priority_wins(self):
        q = AdmissionQueue(8, aging_s=30.0)
        q.offer("old-low", priority=0)
        q.offer("fresh-high", priority=2)
        assert q.take_batch(timeout=0.1) == ["fresh-high"]


# ---------------------------------------------------------------------------
# Per-tenant pending caps
# ---------------------------------------------------------------------------


class TestTenantCaps:
    def test_cap_rejects_naming_tenant_with_retry_hint(self):
        q = AdmissionQueue(16,
                           tenants={"greedy": TenantPolicy(
                               weight=1.0, max_pending=2)})
        q.offer("g0", tenant="greedy")
        q.offer("g1", tenant="greedy")
        with pytest.raises(BackpressureError) as ei:
            q.offer("g2", tenant="greedy")
        err = ei.value
        assert err.tenant == "greedy"
        assert "greedy" in str(err)
        assert err.queue_depth == 2 and err.capacity == 2
        assert err.retry_after_s is not None and err.retry_after_s > 0
        # Other tenants are unaffected by the greedy tenant's cap.
        q.offer("other", tenant="quiet")

    def test_in_flight_counts_against_cap_until_release(self):
        q = AdmissionQueue(16, tenants={"t": TenantPolicy(
            weight=1.0, max_pending=1)})
        q.offer("x", tenant="t")
        assert q.take_batch(timeout=0.1) == ["x"]
        assert q.pending("t") == 1         # claimed but not released
        with pytest.raises(BackpressureError):
            q.offer("y", tenant="t")
        q.release("t")
        q.offer("y", tenant="t")           # slot freed

    def test_set_tenant_updates_policy(self):
        q = AdmissionQueue(16)
        q.set_tenant("t", weight=2.0, max_pending=1)
        assert q.policy("t") == TenantPolicy(2.0, 1)
        q.offer("x", tenant="t")
        with pytest.raises(BackpressureError):
            q.offer("y", tenant="t")

    def test_readmit_bypasses_tenant_cap(self):
        q = AdmissionQueue(16, tenants={"t": TenantPolicy(
            weight=1.0, max_pending=1)})
        q.offer("x", tenant="t")
        q.readmit("recovered", tenant="t")     # recovery must not shed
        assert q.snapshot() == ["recovered", "x"]


# ---------------------------------------------------------------------------
# Fusion scan across tenants
# ---------------------------------------------------------------------------


class TestCrossTenantFusion:
    def test_followers_claimed_across_tenants_in_arrival_order(self):
        q = AdmissionQueue(16, tenants={"a": TenantPolicy(1.0),
                                        "b": TenantPolicy(1.0)})
        q.offer("a-x1", tenant="a")
        q.offer("b-x2", tenant="b")
        q.offer("a-y1", tenant="a")
        q.offer("b-x3", tenant="b")
        same = lambda head, other: other.split("-")[1][0] == \
            head.split("-")[1][0]
        batch = q.take_batch(timeout=0.1, compatible=same)
        assert batch == ["a-x1", "b-x2", "b-x3"]
        # Each claimed entry charges in-flight to its own tenant.
        assert q.pending("a") == 2         # a-x1 in flight + a-y1 queued
        assert q.pending("b") == 2         # b-x2, b-x3 in flight


# ---------------------------------------------------------------------------
# retry_after_s estimation (completion rate, executors-aware fallback)
# ---------------------------------------------------------------------------


class TestRetryAfterEstimate:
    def _estimate(self, q):
        with pytest.raises(BackpressureError) as ei:
            q.offer("rejected")
        return ei.value.retry_after_s

    def test_no_history_defaults_to_one_second(self):
        q = AdmissionQueue(1)
        q.offer("x")
        assert self._estimate(q) == 1.0

    def test_completion_rate_is_the_primary_signal(self):
        # One completion every 0.2s, one item ahead -> ~0.4s.  The
        # executors knob must NOT divide this: parallel workers'
        # completions already interleave in the observed stream.
        q = AdmissionQueue(1, executors=8)
        t0 = time.monotonic()
        q._done_times.extend([t0 - 0.4, t0 - 0.2, t0])
        q.offer("x")
        assert self._estimate(q) == pytest.approx(0.4, rel=0.05)

    def test_claim_rate_fallback_divides_by_executors(self):
        # Before any completion lands, the claim rate stands in — but
        # a single dispatcher feeding an N-wide pool claims on one
        # thread's clock, so the interval is divided by the width.
        t0 = time.monotonic()
        estimates = {}
        for width in (1, 4):
            q = AdmissionQueue(1, executors=width)
            q._claim_times.extend([t0 - 0.8, t0 - 0.4, t0])
            q.offer("x")
            estimates[width] = self._estimate(q)
        assert estimates[1] == pytest.approx(0.8, rel=0.05)
        assert estimates[4] == pytest.approx(0.2, rel=0.05)

    def test_estimate_is_clamped_to_sane_bounds(self):
        t0 = time.monotonic()
        slow = AdmissionQueue(1)
        slow._done_times.extend([t0 - 500.0, t0])
        slow.offer("x")
        assert self._estimate(slow) == 60.0
        fast = AdmissionQueue(1)
        fast._done_times.extend([t0 - 1e-4, t0])
        fast.offer("x")
        assert self._estimate(fast) == 0.05


# ---------------------------------------------------------------------------
# The copies are the reference's code
# ---------------------------------------------------------------------------


def _code(path):
    """A module's AST with every docstring dropped and the reference's
    package name read as the port's, dumped."""
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("'repro.", "'repro_torch.")


@pytest.mark.parametrize("module", ["runtime/admission.py",
                                    "runtime/transport.py",
                                    "core/client.py"])
def test_copy_is_the_reference_code(module):
    import pathlib

    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    assert _code(src / "repro_torch" / module) == \
        _code(src / "repro" / module)
