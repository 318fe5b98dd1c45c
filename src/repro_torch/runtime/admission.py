"""Bounded, multi-tenant fair admission control for request services
(the port's own copy of the reference package's ``runtime/admission.py``).

The sweep service (:mod:`repro_torch.core.service`) accepts work through a
bounded queue: once the backlog reaches a configurable cap, further
submissions are **rejected at the door** with a
:class:`BackpressureError` that names the depth, the cap and a
``retry_after_s`` hint — never buffered without bound (memory growth
until OOM) and never blocked (a deadlock when the submitter is also
the consumer).  Rejection is the only load-shedding mechanism: work
that *was* admitted is never dropped.

Admission is **multi-tenant fair**.  Every item is offered under a
tenant name (default ``"default"``) and a priority class, and the
consumer side schedules across tenants with three composable rules:

* **Weighted fair scheduling (deficit round-robin)** — each tenant
  accrues ``weight × quantum`` of service credit per scheduler
  rotation and spends one unit per claimed request, so under
  sustained overload tenants converge to their weight share of
  completed work regardless of offered load.  A tenant whose backlog
  empties leaves the rotation with its credit reset (no hoarding
  while idle); with a single tenant the scheduler degenerates to the
  plain FIFO the pre-tenant service ran.
* **Priority classes with aging** — within a tenant, the highest
  *effective* priority is claimed first; effective priority is
  ``priority + age // aging_s``, so a low-priority request gains one
  class per ``aging_s`` seconds waited and can never starve behind a
  sustained stream of higher-priority work.  Ties (same effective
  class) serve FIFO.
* **Per-tenant pending caps** — a tenant with
  :class:`TenantPolicy` ``max_pending`` set is rejected at the door
  (with the tenant named in the :class:`BackpressureError`) once its
  queued + in-flight count reaches the cap, so one greedy tenant
  cannot occupy the whole shared backlog.  In-flight counts are
  maintained by :meth:`AdmissionQueue.take_batch` and returned by the
  consumer via :meth:`AdmissionQueue.release`.

The queue itself is deliberately small and lock-based (per-tenant
``deque``\\ s under one mutex with a condition variable): admission
happens on client threads, consumption on the service worker, and the
fusion scan (:meth:`AdmissionQueue.take_batch`) must claim a head item
plus every compatible follower atomically, which the stdlib
``queue.Queue`` cannot express.

:class:`Deadline` is the tiny monotonic-clock companion: requests
carry one, and the executor's ``should_stop`` hook polls it between
chunk dispatches.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

#: One unit of scheduler credit is spent per claimed request.
_COST = 1.0


class BackpressureError(RuntimeError):
    """A submission was rejected because the admission queue is full.

    Carries ``queue_depth`` (backlog at rejection time), ``capacity``
    (the cap that fired — the global backlog cap, or the tenant's
    ``max_pending`` when ``tenant`` is set), the offending ``tenant``
    (``None`` for global-capacity rejections) and ``retry_after_s``
    (an estimate of when a retry is likely to be admitted, derived
    from the queue's recent service rate) so clients can implement
    retry/backoff without parsing the message.  Raised *instead of*
    blocking or buffering — admitted work is unaffected.
    """

    def __init__(self, queue_depth: int, capacity: int,
                 reason: str = "admission queue full",
                 tenant: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        self.queue_depth = int(queue_depth)
        self.capacity = int(capacity)
        self.reason = str(reason)
        self.tenant = tenant
        self.retry_after_s = (None if retry_after_s is None
                              else float(retry_after_s))
        who = (f"tenant {tenant!r} pending" if tenant is not None
               else "queue depth")
        hint = (f"retry after ~{self.retry_after_s:.2f}s"
                if self.retry_after_s is not None
                else "retry after in-flight requests drain")
        super().__init__(
            f"{self.reason}: {who} {self.queue_depth} >= capacity "
            f"{self.capacity} — {hint}, or raise the "
            f"{'tenant cap' if tenant is not None else 'service capacity'}")


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission policy of one tenant.

    ``weight`` is the deficit-round-robin share (relative to the other
    tenants' weights — 1:3 weights converge to a 25%/75% split of
    claimed work under overload).  ``max_pending`` caps the tenant's
    queued + in-flight requests; beyond it :meth:`AdmissionQueue.offer`
    rejects with a :class:`BackpressureError` naming the tenant
    (``None`` = uncapped).
    """

    weight: float = 1.0
    max_pending: Optional[int] = None

    def __post_init__(self):
        if not (self.weight > 0.0):
            raise ValueError(f"tenant weight must be > 0, "
                             f"got {self.weight}")
        if self.max_pending is not None and int(self.max_pending) < 1:
            raise ValueError(f"max_pending must be >= 1, "
                             f"got {self.max_pending}")


@dataclasses.dataclass(frozen=True)
class Deadline:
    """A wall-deadline on the monotonic clock (``None`` = none).

    Built with :meth:`after`; ``expired()`` is what a service wires
    into ``stream_grid(should_stop=...)`` so an overdue request stops
    within one chunk dispatch and returns its consistent partial
    snapshot.
    """

    at: Optional[float] = None          # time.monotonic() timestamp

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        """Deadline ``seconds`` from now (``None`` → no deadline)."""
        if seconds is None:
            return cls(None)
        return cls(time.monotonic() + float(seconds))

    def expired(self) -> bool:
        return self.at is not None and time.monotonic() >= self.at

    def remaining_s(self) -> Optional[float]:
        """Seconds until expiry (negative once overdue; ``None`` when
        no deadline is set)."""
        if self.at is None:
            return None
        return self.at - time.monotonic()

    @staticmethod
    def earliest(*deadlines: "Deadline") -> "Deadline":
        """The tightest of several deadlines (used when fused requests
        with different deadlines share one execution)."""
        ats = [d.at for d in deadlines if d.at is not None]
        return Deadline(min(ats)) if ats else Deadline(None)


@dataclasses.dataclass
class _Entry:
    """One queued item plus its scheduling metadata."""

    item: object
    tenant: str
    priority: int
    seq: int            # global arrival order (readmits get negatives)
    t_enq: float        # monotonic enqueue time (aging reference)


class AdmissionQueue:
    """Bounded multi-tenant queue with reject-at-capacity admission,
    weighted fair scheduling and atomic batch claiming.

    * :meth:`offer` — non-blocking admission under a tenant/priority;
      raises :class:`BackpressureError` once the global backlog
      reaches ``capacity`` or the tenant's ``max_pending`` (queued +
      in-flight) cap is hit.
    * :meth:`take_batch` — blocking (with timeout) claim of the next
      scheduled item (deficit round-robin across tenants, effective
      priority within a tenant) plus every queued item a
      ``compatible`` predicate accepts against that head, removed
      atomically under one lock (the fusion scan of the sweep
      service).  Claimed items count as in-flight for their tenant
      until :meth:`release`\\ d.
    * :meth:`readmit` — put recovered work back at the *front of its
      tenant's class*, bypassing the capacity checks: crash recovery
      must never lose admitted requests to a full queue, and recovered
      work keeps its original position ahead of new arrivals.
    * :meth:`remove` — withdraw one queued item (client cancel before
      the worker claimed it).
    * :meth:`pause` / :meth:`resume` — stop/restart claiming without
      closing admission: a paused :meth:`take_batch` blocks (up to its
      timeout) even when the backlog is non-empty.

    With every item offered under the default tenant and priority the
    scheduler is exactly the old bounded FIFO.
    """

    def __init__(self, capacity: int,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 aging_s: float = 30.0,
                 quantum: float = 1.0,
                 executors: int = 1):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (aging_s > 0.0):
            raise ValueError(f"aging_s must be > 0, got {aging_s}")
        self.capacity = int(capacity)
        self.aging_s = float(aging_s)
        self.quantum = float(quantum)
        #: Parallel service width (e.g. the worker-pool size) — scales
        #: the claim-rate fallback of the ``retry_after_s`` estimate.
        self.executors = max(1, int(executors))
        self._policies: Dict[str, TenantPolicy] = dict(tenants or {})
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rr: deque = deque()           # DRR rotation (active tenants)
        self._deficit: Dict[str, float] = {}
        self._inflight: Dict[str, int] = {}
        self._depth = 0
        self._seq = 0
        self._rseq = 0                      # readmit seqs count downward
        self._paused = False
        self._claim_times: deque = deque(maxlen=32)
        self._done_times: deque = deque(maxlen=32)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)

    # -- tenant policy ----------------------------------------------------

    def set_tenant(self, name: str, weight: float = 1.0,
                   max_pending: Optional[int] = None) -> None:
        """Register (or update) one tenant's fairness policy."""
        with self._lock:
            self._policies[str(name)] = TenantPolicy(float(weight),
                                                     max_pending)

    def policy(self, name: str) -> TenantPolicy:
        with self._lock:
            return self._policies.get(name, TenantPolicy())

    # -- introspection -----------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def pending(self, tenant: str = "default") -> int:
        """Queued + in-flight count of one tenant (what ``max_pending``
        is enforced against)."""
        with self._lock:
            return (len(self._queues.get(tenant, ()))
                    + self._inflight.get(tenant, 0))

    def snapshot(self) -> List:
        """Point-in-time copy of the backlog in arrival order
        (readmitted recovery work first — health reporting)."""
        with self._lock:
            entries = [e for q in self._queues.values() for e in q]
        entries.sort(key=lambda e: e.seq)
        return [e.item for e in entries]

    # -- admission ---------------------------------------------------------

    def offer(self, item, tenant: str = "default",
              priority: int = 0) -> None:
        with self._not_empty:
            pol = self._policies.get(tenant, TenantPolicy())
            if self._depth >= self.capacity:
                raise BackpressureError(
                    self._depth, self.capacity,
                    retry_after_s=self._retry_after_locked(self._depth))
            tq = self._queues.get(tenant)
            t_pending = ((len(tq) if tq is not None else 0)
                         + self._inflight.get(tenant, 0))
            if pol.max_pending is not None \
                    and t_pending >= pol.max_pending:
                raise BackpressureError(
                    t_pending, pol.max_pending,
                    reason="tenant pending cap reached", tenant=tenant,
                    retry_after_s=self._retry_after_locked(t_pending))
            self._seq += 1
            self._enqueue_locked(_Entry(item, tenant, int(priority),
                                        self._seq, time.monotonic()))
            self._not_empty.notify()

    def readmit(self, item, tenant: str = "default",
                priority: int = 0) -> None:
        with self._not_empty:
            self._rseq -= 1
            self._enqueue_locked(_Entry(item, tenant, int(priority),
                                        self._rseq, time.monotonic()),
                                 front=True)
            self._not_empty.notify()

    def _enqueue_locked(self, e: _Entry, front: bool = False) -> None:
        q = self._queues.get(e.tenant)
        if q is None:
            q = self._queues[e.tenant] = deque()
        if not q and e.tenant not in self._rr:
            self._rr.append(e.tenant)
            self._deficit.setdefault(e.tenant, 0.0)
        (q.appendleft if front else q.append)(e)
        self._depth += 1

    def remove(self, item) -> bool:
        with self._lock:
            for tenant, q in self._queues.items():
                for e in q:
                    if e.item == item:
                        q.remove(e)
                        self._depth -= 1
                        if not q:
                            self._deactivate_locked(tenant)
                        return True
            return False

    def release(self, tenant: str = "default") -> None:
        """Return one claimed item's in-flight slot (the consumer calls
        this when the item's execution finishes, successfully or not)."""
        with self._lock:
            self._done_times.append(time.monotonic())
            n = self._inflight.get(tenant, 0)
            if n > 1:
                self._inflight[tenant] = n - 1
            else:
                self._inflight.pop(tenant, None)

    # -- flow control --------------------------------------------------

    def pause(self) -> None:
        """Stop claiming (``take_batch`` blocks/returns ``[]``) while
        leaving admission open — the deterministic knob the
        backpressure/fusion tests are built on."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._not_empty:
            self._paused = False
            self._not_empty.notify_all()

    @property
    def paused(self) -> bool:
        with self._lock:
            return self._paused

    # -- scheduling ----------------------------------------------------

    def _deactivate_locked(self, tenant: str) -> None:
        # A tenant leaving the rotation resets its credit: idle tenants
        # must not hoard deficit and burst past their share later.
        try:
            self._rr.remove(tenant)
        except ValueError:
            pass
        self._deficit.pop(tenant, None)
        if not self._queues.get(tenant):
            self._queues.pop(tenant, None)

    def _effective_priority(self, e: _Entry, now: float) -> int:
        # One priority class gained per aging_s waited: a starved
        # low-priority entry eventually outranks fresh high-priority
        # arrivals.  Integer steps keep same-class FIFO ordering exact
        # (no float-age jitter between near-simultaneous arrivals).
        return e.priority + int((now - e.t_enq) // self.aging_s)

    def _pop_best_locked(self, tenant: str, now: float) -> _Entry:
        q = self._queues[tenant]
        best = min(q, key=lambda e: (-self._effective_priority(e, now),
                                     e.seq))
        q.remove(best)
        self._depth -= 1
        if not q:
            self._deactivate_locked(tenant)
        return best

    def _select_head_locked(self) -> Optional[_Entry]:
        """Deficit round-robin across active tenants; the winner's best
        effective-priority entry is popped.  ``None`` when empty."""
        if not self._rr:
            return None
        now = time.monotonic()
        while True:
            tenant = self._rr[0]
            q = self._queues.get(tenant)
            if not q:
                self._deactivate_locked(tenant)
                if not self._rr:
                    return None
                continue
            if self._deficit.get(tenant, 0.0) >= _COST:
                self._deficit[tenant] -= _COST
                return self._pop_best_locked(tenant, now)
            pol = self._policies.get(tenant, TenantPolicy())
            self._deficit[tenant] = (self._deficit.get(tenant, 0.0)
                                     + self.quantum * pol.weight)
            self._rr.rotate(-1)

    def _retry_after_locked(self, n_ahead: int) -> float:
        """Estimate of when a retry is likely to be admitted (clamped
        to [0.05s, 60s]; 1s with no service history).

        Primary signal: the recent *completion* rate — intervals
        between :meth:`release` calls — extrapolated over the backlog
        ahead.  Completions are what actually free capacity, and with
        parallel consumers they interleave, so their observed rate
        already includes the service width.  Fallback before any
        completion lands: the claim rate divided by ``executors`` — a
        single dispatcher feeding an N-wide worker pool claims on one
        thread's clock, so the raw claim interval over-estimates the
        wait by exactly that factor."""
        est = 1.0
        if len(self._done_times) >= 2:
            span = self._done_times[-1] - self._done_times[0]
            if span > 0:
                per_done = span / (len(self._done_times) - 1)
                est = per_done * (int(n_ahead) + 1)
        elif len(self._claim_times) >= 2:
            span = self._claim_times[-1] - self._claim_times[0]
            if span > 0:
                per_claim = (span / (len(self._claim_times) - 1)
                             / self.executors)
                est = per_claim * (int(n_ahead) + 1)
        return float(min(60.0, max(0.05, est)))

    def take_batch(self, timeout: Optional[float] = None,
                   compatible: Optional[Callable] = None,
                   max_batch: Optional[int] = None) -> List:
        """Claim the next scheduled item and its compatible followers.

        Blocks up to ``timeout`` seconds for a claimable item (``[]``
        on timeout, and always ``[]`` while :meth:`pause`\\ d).  The
        head is chosen by deficit round-robin across tenants and
        effective priority (with aging) within the winner; only the
        head's tenant is charged scheduler credit.  With a
        ``compatible(head, other) -> bool`` predicate, every queued
        follower it accepts — scanned across all tenants in arrival
        order — is claimed in the same critical section (at most
        ``max_batch`` items total), so a concurrent ``offer`` can
        never interleave into a claimed batch.  Every claimed item
        counts as in-flight for its tenant until :meth:`release`.
        """
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._not_empty:
            while self._paused or self._depth == 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return []
                self._not_empty.wait(remaining)
            head = self._select_head_locked()
            if head is None:            # woken by a racing remove()
                return []
            claimed = [head]
            if compatible is not None:
                cap = (max_batch if max_batch is not None
                       else float("inf"))
                rest = sorted((e for q in self._queues.values()
                               for e in q), key=lambda e: e.seq)
                for e in rest:
                    if len(claimed) >= cap:
                        break
                    if compatible(head.item, e.item):
                        self._queues[e.tenant].remove(e)
                        self._depth -= 1
                        if not self._queues[e.tenant]:
                            self._deactivate_locked(e.tenant)
                        claimed.append(e)
            for e in claimed:
                self._inflight[e.tenant] = \
                    self._inflight.get(e.tenant, 0) + 1
            self._claim_times.append(time.monotonic())
            return [e.item for e in claimed]
