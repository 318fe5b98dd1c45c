"""Sweep-as-a-service: a crash-safe, persistent co-design server (the
port of the reference package's ``core/service.py``, on the port's
streaming executor).

One-shot :func:`repro_torch.core.stream.stream_grid` calls pay spec
resolution and (on a cold process) step building and graph capture per
call, and give a caller no admission control, no deadlines and no
recovery story.  This module wraps the streaming executor in a
**long-lived service** for many concurrent design-space queries:

* **One device** — a service runs every in-process execution on the one
  device it was built with (``device="cuda"`` by default, resolved once:
  without a card it raises unless given ``device="cpu"``), as one shard,
  so its plans, and the worker processes that rebuild them, derive the
  same chunk geometry and ``signature`` however many cards are visible.
  The device never enters a :class:`SweepRequest` or its journal entry,
  so journals and signatures are the reference's.

* **Bounded admission with explicit backpressure** — requests enter
  through :class:`repro_torch.runtime.admission.AdmissionQueue`; once
  the backlog reaches ``capacity`` further submissions are rejected with
  :class:`repro_torch.runtime.admission.BackpressureError` (never unbounded
  buffering, never a blocking deadlock, and admitted work is never
  dropped).
* **Compiled-plan reuse** — resolved :class:`repro_torch.core.stream.
  StreamPlan` objects are held in an LRU keyed by their content
  ``signature`` (:func:`repro_torch.core.backend.job_signature`).  The
  :class:`~repro_torch.core.backend.ChunkSpec` inside a plan hashes its
  model stack by identity, so *only* re-submitting the same plan
  object makes :func:`repro_torch.core.backend.cached_step` return the
  already-compiled chunk step — the plan cache is what turns repeat
  queries compile-free across requests.
* **Per-request deadlines and cooperative cancel** — each request's
  :class:`~repro_torch.runtime.admission.Deadline` (and its
  :meth:`Ticket.cancel`) is wired into ``stream_grid(should_stop=)``,
  polled between chunk dispatches: an overdue or cancelled request
  stops within one chunk and returns the executor's consistent prefix
  snapshot as a ``partial=True`` :class:`~repro_torch.core.stream.
  StreamResult` (argmin/top-k/front so far + ``fraction_complete``)
  instead of an error.
* **Crash recovery** — with a ``spool_dir``, every request is
  journaled (atomic tmp+rename JSON) and executions checkpoint under
  ``spool/ckpt/<signature>`` through the executor's carry contract.  A
  SIGKILL'd server restarted over the same spool re-admits queued and
  in-flight requests and resumes them from the newest snapshot with
  **bitwise-identical** final results.
* **Retry / graceful degradation** — transient dispatch faults retry
  with exponential backoff (:class:`repro_torch.runtime.RetryPolicy`),
  dead device shards trigger the elastic replan
  (:func:`repro_torch.runtime.elastic.drop_worker`) down to single-device
  execution, all inside the executor; the service aggregates the
  resilience counters across requests.
* **Request fusion** — compatible queued requests (same model stack,
  axes, backend, chunk geometry, constraints and histogram spec —
  typically differing only in objectives, tracked channels or top-k)
  are claimed atomically and fused into **one** stacked dispatch; each
  member's exact deliverables are sliced back out of the fused result.
  Fusion is exactness-first: per-channel argmin/top-k slice exactly,
  the shared Pareto front is only handed to members whose objective
  tuple equals the fused tuple, and requests carrying deadlines never
  fuse (one member's deadline must not truncate another's answer).
* **Health surface** — :meth:`SweepService.health` reports liveness,
  queue depth/capacity, per-request state + progress, plan/step cache
  hit rates and the aggregated resilience counters.

Run it in-process (``with SweepService(...) as svc: svc.submit(...)``)
or as ``python -m repro_torch.service`` (see :func:`main`) for a
spool-backed batch server.  Deterministic recovery-path coverage lives
in ``tests/test_torch_service.py``, driven by
:class:`repro_torch.runtime.FaultInjector`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..runtime.admission import AdmissionQueue, BackpressureError, Deadline
from ..runtime.fault_tolerance import RetryPolicy
from . import backend as B
from . import pareto as P
from . import stream as ST
from . import sweep as SW

#: Grid-axis keyword arguments a :class:`SweepRequest` may carry (the
#: axis surface of :func:`repro_torch.core.stream.plan_stream`).
GRID_KEYS = frozenset({
    "cuts", "agg_nodes", "sensor_nodes", "weight_mems", "detnet_fps",
    "keynet_fps", "num_cameras", "mipi_energy_scale", "camera_fps",
    "detnet", "keynet", "model", "models", "scenarios",
})

#: Ticket lifecycle states.
QUEUED, RUNNING, DONE, FAILED, CANCELLED = (
    "queued", "running", "done", "failed", "cancelled")


class _PoolPreempted(Exception):
    """Internal: shutdown hit a pooled execution — leave the tickets
    unfinished (``close()`` journals them still-RUNNING) so recovery
    over the same spool reattaches to the lease board."""


class _PoolCancelled(Exception):
    """Internal: every member of a pooled execution cancelled."""


class CancelledError(RuntimeError):
    """The request was cancelled before any chunk was dispatched."""


class ServiceClosedError(RuntimeError):
    """The service shut down (or its worker died) before the request
    finished.  Raised by :meth:`Ticket.result` instead of hanging
    forever on a ticket nothing will ever complete; with a spool the
    request's journal keeps its pre-shutdown state, so a later service
    over the same spool resumes it."""


@dataclasses.dataclass(frozen=True)
class SweepRequest:
    """One design-space query against the sweep service.

    ``grid`` holds the axis arguments of
    :func:`repro_torch.core.stream.stream_grid` (see :data:`GRID_KEYS`);
    the
    remaining fields mirror the executor's sweep-defining knobs plus
    the service-level ones: ``deadline_s`` (seconds from *submission*
    after which the request returns its consistent ``partial=True``
    snapshot), ``need_front`` (set ``False`` when the Pareto front is
    not wanted — it widens fusion eligibility), and ``fuse`` (opt out
    of being batched with compatible requests).  ``tenant`` and
    ``priority`` are scheduling metadata for the multi-tenant
    admission queue: weighted fair scheduling across tenants, higher
    ``priority`` claimed first within one (with aging, so low-priority
    work never starves) — they never affect results or fusion
    eligibility.  Requests built only from JSON-able values (axis
    tuples, profile names, numbers) are journaled and survive a server
    crash; requests embedding live model objects still run but are not
    recoverable.
    """

    grid: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    objectives: Sequence[str] = P.DEFAULT_OBJECTIVES
    maximize: Sequence[str] = ()
    track: Optional[Sequence[str] | str] = None
    constraints: Any = None
    top_k: int = 4
    hist_bins: int = 0
    hist_ranges: Optional[Mapping] = None
    chunk_size: int = ST.DEFAULT_CHUNK
    scan_chunks: Optional[int] = None
    backend: Optional[str] = None
    deadline_s: Optional[float] = None
    need_front: bool = True
    fuse: bool = True
    tenant: str = "default"
    priority: int = 0

    def normalized(self) -> "SweepRequest":
        """Canonical form: tuples for sequences, validated grid keys,
        constraints pre-parsed to ``((field, op, bound), ...)``."""
        bad = set(self.grid) - GRID_KEYS
        if bad:
            raise ValueError(f"unknown grid axes {sorted(bad)}; valid "
                             f"axes are {sorted(GRID_KEYS)}")
        grid = {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                for k, v in self.grid.items()}
        track = self.track
        if track is not None and track != "all":
            track = tuple(track)
        hr = self.hist_ranges
        if hr is not None:
            hr = {k: (float(lo), float(hi)) for k, (lo, hi) in hr.items()}
        return dataclasses.replace(
            self, grid=grid, objectives=tuple(self.objectives),
            maximize=tuple(self.maximize), track=track,
            constraints=SW.parse_constraints(self.constraints),
            top_k=int(self.top_k), hist_bins=int(self.hist_bins),
            hist_ranges=hr, chunk_size=int(self.chunk_size),
            deadline_s=(None if self.deadline_s is None
                        else float(self.deadline_s)),
            tenant=str(self.tenant), priority=int(self.priority))

    # -- journal serialization ------------------------------------------

    def to_json(self) -> dict:
        """JSON-able dict (raises ``TypeError`` when the request embeds
        live model objects — such requests are volatile by design)."""
        d = dataclasses.asdict(self.normalized())
        json.dumps(d)       # fail fast on non-journalable payloads
        return d

    @classmethod
    def from_json(cls, d: Mapping) -> "SweepRequest":
        return cls(**d).normalized()


def plan_kwargs(req: SweepRequest) -> dict:
    """The exact :func:`repro_torch.core.stream.plan_stream` kwargs a
    request resolves to (the device aside: each side adds its own one).
    Shared by the in-process executor and the worker-pool processes
    (:mod:`repro_torch.runtime.workers`) so both sides derive the same
    plan — and therefore the same ``plan.signature`` — from one
    journaled request."""
    kw = dict(req.grid)
    kw.update(chunk_size=req.chunk_size, top_k=req.top_k,
              objectives=req.objectives, maximize=req.maximize,
              track=req.track, constraints=req.constraints,
              hist_bins=req.hist_bins, hist_ranges=req.hist_ranges,
              backend=req.backend, scan_chunks=req.scan_chunks)
    return kw


def _request_fields(req: SweepRequest, kfields: tuple) -> tuple:
    """The tracked-field tuple a solo run of ``req`` would reduce —
    mirrors :func:`repro_torch.core.stream.plan_stream`'s field
    resolution."""
    objectives = tuple(req.objectives)
    if req.track == "all":
        extra: tuple = kfields
    else:
        extra = tuple(req.track) if req.track is not None else ()
    extra = extra + tuple(f for f, _, _ in SW.parse_constraints(
        req.constraints))
    return objectives + tuple(dict.fromkeys(
        f for f in extra if f not in objectives))


def _fusion_key(req: SweepRequest):
    """Hashable identity of everything fused requests must share: the
    grid axes / model stack, backend, chunk geometry, constraints and
    histogram spec.  ``None`` when the request cannot be keyed (never
    fuses)."""
    try:
        grid_key = tuple(sorted(req.grid.items()))
        hr = req.hist_ranges
        hr_key = tuple(sorted(hr.items())) if hr else None
        key = (grid_key, req.backend, req.chunk_size, req.scan_chunks,
               tuple(req.constraints or ()), req.hist_bins, hr_key)
        hash(key)
        return key
    except TypeError:
        return None


def _fusable(a: SweepRequest, b: SweepRequest) -> bool:
    """Can ``b`` ride ``a``'s dispatch with exact per-member results?

    Requires the shared :func:`_fusion_key`, agreeing min/max senses on
    shared objectives, no deadlines (one member's deadline must never
    truncate another's answer), and — when the head wants a Pareto
    front — follower objectives contained in the head's (the fused
    front is computed over the head's exact objective tuple)."""
    if a.deadline_s is not None or b.deadline_s is not None:
        return False
    ka = _fusion_key(a)
    if ka is None or ka != _fusion_key(b):
        return False
    for o in set(a.objectives) & set(b.objectives):
        if (o in a.maximize) != (o in b.maximize):
            return False
    if a.need_front:
        if not set(b.objectives) <= set(a.objectives):
            return False
        if b.need_front and tuple(b.objectives) != tuple(a.objectives):
            return False
    elif b.need_front:
        return False
    return True


def _fused_request(reqs: Sequence[SweepRequest]) -> SweepRequest:
    """One request whose reductions cover every member exactly: union
    objectives (head order first), union maximize/track, max top-k."""
    head = reqs[0]
    objectives = list(head.objectives)
    for r in reqs[1:]:
        objectives.extend(o for o in r.objectives if o not in objectives)
    maximize = tuple(o for o in objectives
                     if any(o in r.maximize for r in reqs))
    if any(r.track == "all" for r in reqs):
        track: Any = "all"
    else:
        seen: list = []
        for r in reqs:
            seen.extend(t for t in (r.track or ()) if t not in seen)
        track = tuple(seen) or None
    return dataclasses.replace(
        head, objectives=tuple(objectives), maximize=maximize,
        track=track, top_k=max(r.top_k for r in reqs),
        need_front=any(r.need_front for r in reqs), deadline_s=None)


class Ticket:
    """Handle to one submitted request: state, progress, cancel, and
    the (possibly partial) :class:`~repro_torch.core.stream.StreamResult`.

    Thread-safe; returned by :meth:`SweepService.submit`.  ``state``
    walks ``queued → running → done | failed | cancelled``.
    """

    def __init__(self, tid: str, seq: int, request: SweepRequest,
                 service: "SweepService",
                 client_id: Optional[str] = None):
        self.id = tid
        self.seq = seq
        self.request = request
        self.client_id = client_id
        self.tenant = request.tenant
        self.deadline = Deadline.after(request.deadline_s)
        self.state = QUEUED
        self.progress = 0.0
        self.signature: Optional[str] = None
        self.snapshot: Optional[dict] = None
        self._service = service
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._snap_seq = 0
        self._snap_cond = threading.Condition()
        self._result: Optional[ST.StreamResult] = None
        self._error: Optional[BaseException] = None

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Cooperative cancel: a queued request is withdrawn before it
        runs; a running one stops within one chunk dispatch and still
        delivers its consistent ``partial=True`` snapshot."""
        self._cancel.set()
        self._service._cancel_queued(self)

    def result(self, timeout: Optional[float] = None) -> ST.StreamResult:
        """Block for the outcome.  Raises :class:`TimeoutError` when
        not finished within ``timeout``, :class:`ServiceClosedError`
        when the service shuts down (or its worker dies) with the
        ticket still unfinished — never a silent forever-hang —
        re-raises the request's failure, and returns the partial
        snapshot for deadline-expired or mid-run-cancelled requests."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not self._done.is_set():
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"request {self.id} not finished within {timeout}s "
                    f"(state {self.state}, "
                    f"progress {self.progress:.0%})")
            svc = self._service
            if (svc is not None and not svc._worker.is_alive()
                    and not self._done.is_set()):
                raise ServiceClosedError(
                    f"service closed with request {self.id} still "
                    f"{self.state} — nothing will finish it; restart "
                    f"a service over the same spool to resume")
            self._done.wait(0.1 if remaining is None
                            else min(0.1, remaining))
        if self._result is None and self._error is not None:
            raise self._error
        return self._result

    # -- incremental progress snapshots ---------------------------------

    def _update_snapshot(self, snap: dict) -> None:
        with self._snap_cond:
            self.snapshot = snap
            self.progress = float(snap.get("fraction_complete",
                                           self.progress))
            self._snap_seq += 1
            self._snap_cond.notify_all()

    def wait_snapshot(self, last_seq: int = 0,
                      timeout: Optional[float] = None):
        """Block until a progress snapshot newer than ``last_seq``
        lands (or the ticket finishes, or ``timeout``).  Returns
        ``(seq, snapshot)`` — pass ``seq`` back in to long-poll the
        next one; ``snapshot`` is a JSON-able consistent prefix
        summary (``fraction_complete``, running per-objective best,
        front size).  The transport's ``watch`` op streams these to
        subscribed clients."""
        with self._snap_cond:
            if self._snap_seq <= last_seq and not self._done.is_set():
                self._snap_cond.wait(timeout)
            return self._snap_seq, self.snapshot

    def summary(self) -> dict:
        return {"id": self.id, "state": self.state,
                "progress": round(float(self.progress), 4),
                "cancelled": self.cancelled,
                "partial": bool(self._result.partial
                                if self._result is not None else False),
                "signature": (self.signature or "")[:16]}


class SweepService:
    """Persistent crash-safe sweep server over :func:`stream_grid`.

    ``spool_dir`` enables the crash-recovery contract: request journal
    under ``<spool>/requests`` and per-job checkpoints under
    ``<spool>/ckpt/<signature>``; a new service over the same spool
    re-admits unfinished requests (``recover=False`` to skip) and
    resumes them bitwise-exactly.  ``capacity`` caps the admission
    backlog (:class:`~repro_torch.runtime.admission.BackpressureError`
    beyond it).  ``fuse`` enables compatible-request fusion (at most
    ``max_fuse`` members per dispatch).  ``retry_policy`` /
    ``fault_injector`` / ``prefetch`` / ``checkpoint_every_*`` pass
    through to the executor per execution.  ``device`` is where
    in-process executions run (``"cuda"``: raises without a card;
    ``"cpu"``: the plain PyTorch path); ``workers`` processes each take
    one card (:class:`repro_torch.runtime.workers.WorkerPool`).  All
    public methods are thread-safe; one daemon worker thread executes
    requests FIFO.
    """

    def __init__(self, spool_dir: Optional[str] = None,
                 capacity: int = 16,
                 fuse: bool = True,
                 max_fuse: int = 8,
                 plan_cache_size: int = 16,
                 keep_finished: int = 256,
                 prefetch: int = ST.DEFAULT_PREFETCH,
                 checkpoint_every_s: float = ST.DEFAULT_CHECKPOINT_EVERY_S,
                 checkpoint_every_steps: Optional[int] = None,
                 checkpoint_keep: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 fault_injector=None,
                 recover: bool = True,
                 poll_s: float = 0.05,
                 tenants: Optional[Mapping] = None,
                 aging_s: float = 30.0,
                 snapshot_every_s: float = 0.5,
                 workers: int = 0,
                 worker_ttl_s: float = 10.0,
                 lease_splits: Optional[int] = None,
                 device="cuda"):
        self.device = SW.resolve_device(device)
        self._own_spool = workers > 0 and spool_dir is None
        if self._own_spool:
            import tempfile
            spool_dir = tempfile.mkdtemp(prefix="sweep-spool-")
        self.spool_dir = spool_dir
        self._queue = AdmissionQueue(capacity,
                                     tenants=dict(tenants or {}),
                                     aging_s=aging_s,
                                     executors=max(1, int(workers)))
        self._snapshot_every_s = float(snapshot_every_s)
        self._fuse = bool(fuse)
        self._max_fuse = max(1, int(max_fuse))
        self._plan_cache_size = max(1, int(plan_cache_size))
        self._keep_finished = max(1, int(keep_finished))
        self._prefetch = prefetch
        self._ckpt_every_s = checkpoint_every_s
        self._ckpt_every_steps = checkpoint_every_steps
        self._ckpt_keep = checkpoint_keep
        self._retry_policy = retry_policy
        self._fault_injector = fault_injector
        self._poll_s = float(poll_s)

        self._lock = threading.Lock()
        self._journal_lock = threading.Lock()
        self._plans: "OrderedDict[str, ST.StreamPlan]" = OrderedDict()
        self._tickets: "OrderedDict[str, Ticket]" = OrderedDict()
        self._by_client: dict = {}
        self._running: dict = {}
        self._seq = 0
        self._t0 = time.monotonic()
        self._shutdown = threading.Event()
        self._paused = threading.Event()
        self.counters = {
            "admitted": 0, "rejected": 0, "completed": 0, "failed": 0,
            "cancelled": 0, "deadline_expired": 0, "fused_requests": 0,
            "executions": 0, "recovered": 0, "recovered_finished": 0,
            "deduped": 0, "plan_hits": 0,
            "plan_misses": 0,
            # Aggregated executor resilience counters:
            "retries": 0, "restarts": 0, "chunks_reissued": 0,
            "elastic_replans": 0, "checkpoints_written": 0,
            "stragglers": 0, "step_timeouts": 0,
            # Worker-pool counters (stay 0 without ``workers=``):
            "pooled_executions": 0, "leases_reissued": 0,
        }
        if spool_dir is not None:
            os.makedirs(self._requests_dir, exist_ok=True)
            if recover:
                self._recover()
        self._pool = None
        self._lease_splits = lease_splits
        if workers > 0:
            from ..runtime import workers as WK
            self._pool = WK.WorkerPool(self.spool_dir, int(workers),
                                       ttl_s=float(worker_ttl_s),
                                       device=self.device)
        self._worker = threading.Thread(target=self._run_worker,
                                        daemon=True,
                                        name="sweep-service-worker")
        self._worker.start()

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, drain: bool = False,
              timeout: Optional[float] = 60.0) -> None:
        """Stop the worker.  ``drain=True`` first waits for the backlog
        to empty; otherwise an in-flight request is preempted within
        one chunk (its ticket gets the partial snapshot and, when
        spooled, its journal stays unfinished so a later service over
        the same spool resumes it).  Tickets left unfinished when the
        worker exits fail fast with :class:`ServiceClosedError` —
        their journal keeps the pre-shutdown state, so recovery over
        the same spool still resumes them."""
        if drain:
            while (self._queue.depth or self._running) \
                    and not self._shutdown.is_set():
                time.sleep(self._poll_s)
        self._shutdown.set()
        self._worker.join(timeout)
        if self._pool is not None:
            self._pool.stop()
            if self._own_spool:
                import shutil
                shutil.rmtree(self.spool_dir, ignore_errors=True)
        for t in self.tickets():
            if not t.done():
                pre_state = t.state
                self._finish(
                    t, FAILED,
                    error=ServiceClosedError(
                        f"service closed with request {t.id} still "
                        f"{pre_state} — restart a service over the "
                        f"same spool to resume it"),
                    journal_state=pre_state)

    def pause(self) -> None:
        """Stop claiming new requests (admission stays open) — the
        deterministic knob backpressure/fusion tests are built on.
        Pausing at the queue level closes the race where a worker
        already blocked inside ``take_batch`` claims a submit that
        lands after ``pause()`` returns."""
        self._paused.set()
        self._queue.pause()

    def resume(self) -> None:
        self._queue.resume()
        self._paused.clear()

    # -- submission ------------------------------------------------------

    def submit(self, request: SweepRequest,
               client_id: Optional[str] = None) -> Ticket:
        """Admit one request.  Raises
        :class:`~repro_torch.runtime.admission.BackpressureError` when the
        backlog is at capacity or the tenant's pending cap is hit (the
        request is NOT enqueued), and ``ValueError`` on malformed
        requests — both before any state is journaled.

        ``client_id`` makes the submit **idempotent**: resubmitting
        the same id returns the existing ticket — queued, running or
        already finished, including finished requests recovered from
        the journal after a server restart — instead of executing
        twice.  The id is validated against the original request
        (``ValueError`` on reuse with a different one); this is what
        lets :class:`repro_torch.core.client.SweepClient` blindly retry a
        submit whose response was lost to a dropped connection or a
        server crash."""
        if self._shutdown.is_set():
            raise ServiceClosedError("service is shut down")
        req = request.normalized()
        with self._lock:
            if client_id is not None:
                existing = self._by_client.get(client_id)
                if existing is not None:
                    if existing.request != req:
                        raise ValueError(
                            f"client id {client_id!r} was already used "
                            f"for a different request "
                            f"({existing.id}) — idempotent retries "
                            f"must resubmit the identical request")
                    self.counters["deduped"] += 1
                    return existing
            self._seq += 1
            seq = self._seq
            t = Ticket(f"req-{seq:06d}", seq, req, self,
                       client_id=client_id)
            if client_id is not None:
                self._by_client[client_id] = t
        try:
            self._queue.offer(t, tenant=req.tenant,
                              priority=req.priority)
        except BackpressureError:
            with self._lock:
                self.counters["rejected"] += 1
                if client_id is not None \
                        and self._by_client.get(client_id) is t:
                    del self._by_client[client_id]
            raise
        self._remember(t)
        self._journal(t)
        with self._lock:
            self.counters["admitted"] += 1
        return t

    def set_tenant(self, name: str, weight: float = 1.0,
                   max_pending: Optional[int] = None) -> None:
        """Register (or update) one tenant's fairness policy — DRR
        weight and optional queued+in-flight pending cap."""
        self._queue.set_tenant(name, weight=weight,
                               max_pending=max_pending)

    def get(self, ticket_id: str) -> Optional[Ticket]:
        with self._lock:
            return self._tickets.get(ticket_id)

    def tickets(self) -> list:
        with self._lock:
            return list(self._tickets.values())

    # -- health ----------------------------------------------------------

    def health(self) -> dict:
        """Liveness + queue depth + per-request progress + cache and
        resilience counters (everything JSON-able)."""
        with self._lock:
            counters = dict(self.counters)
            tickets = {tid: t.summary()
                       for tid, t in self._tickets.items()}
            plan_cache = {"size": len(self._plans),
                          "capacity": self._plan_cache_size,
                          "hits": counters.pop("plan_hits"),
                          "misses": counters.pop("plan_misses")}
            running = sorted(self._running)
        workers = (None if self._pool is None else
                   {"n": self._pool.n, "alive": self._pool.alive(),
                    "pids": self._pool.pids()})
        return {
            "workers": workers,
            "alive": self._worker.is_alive()
            and not self._shutdown.is_set(),
            "paused": self._paused.is_set(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queue_depth": self._queue.depth,
            "capacity": self._queue.capacity,
            "in_flight": running,
            "requests": tickets,
            "counters": counters,
            "plan_cache": plan_cache,
            "step_cache": B.step_cache_stats(),
        }

    # -- internals: journal & recovery ----------------------------------

    @property
    def _requests_dir(self) -> str:
        return os.path.join(self.spool_dir, "requests")

    def _ckpt_dir(self, signature: str) -> str:
        return os.path.join(self.spool_dir, "ckpt", signature[:24])

    def _journal(self, t: Ticket, state: Optional[str] = None) -> None:
        """Atomically persist one ticket's journal entry (no-op without
        a spool or for non-JSON-able requests).  ``state`` overrides
        the ticket state — used to leave a shutdown-preempted request
        marked unfinished so recovery re-admits it.  Finished DONE
        entries embed the exact result (:func:`repro_torch.core.stream.
        result_to_json`) so an idempotent resubmit after a server
        restart re-attaches and gets the bitwise-identical answer
        without re-executing."""
        if self.spool_dir is None:
            return
        # One ticket can be journaled concurrently (the submitting
        # thread right after admission, the worker as it claims): the
        # lock keeps the shared tmp path from racing os.replace, and
        # reading t.state *inside* the lock makes the last writer
        # persist the freshest state.
        with self._journal_lock:
            journal_state = state or t.state
            try:
                payload = {"id": t.id, "seq": t.seq,
                           "state": journal_state,
                           "signature": t.signature,
                           "client_id": t.client_id,
                           "request": t.request.to_json(),
                           "error": (str(t._error)
                                     if t._error is not None else None)}
                if journal_state == DONE and t._result is not None:
                    payload["result"] = ST.result_to_json(t._result)
            except TypeError:
                return      # volatile request (live model objects)
            path = os.path.join(self._requests_dir, f"{t.id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)

    def _recover(self) -> None:
        """Re-admit every journaled request left queued or running by a
        previous (possibly SIGKILL'd) service over this spool —
        original admission order, bypassing the capacity cap (admitted
        work is never dropped)."""
        entries = []
        for name in sorted(os.listdir(self._requests_dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._requests_dir, name)) as fh:
                    entries.append(json.load(fh))
            except (OSError, ValueError):
                continue        # torn foreign write: skip, never crash
        self._seq = max([int(e.get("seq", 0)) for e in entries],
                        default=0)
        pending = [e for e in entries
                   if e.get("state") in (QUEUED, RUNNING)]
        pending.sort(key=lambda e: int(e.get("seq", 0)))
        for e in reversed(pending):     # readmit prepends: reverse seq
            try:
                req = SweepRequest.from_json(e["request"])
            except (TypeError, ValueError, KeyError):
                continue
            t = Ticket(e["id"], int(e.get("seq", 0)), req, self,
                       client_id=e.get("client_id"))
            t.signature = e.get("signature")
            self._queue.readmit(t, tenant=req.tenant,
                                priority=req.priority)
            self._remember(t)
            self._journal(t)
            self.counters["recovered"] += 1
        # Finished requests with a journaled result come back as DONE
        # tickets (never re-executed): an idempotent resubmit from a
        # client that crashed mid-wait re-attaches and reads the exact
        # persisted answer.
        for e in entries:
            if e.get("state") != DONE or e.get("result") is None:
                continue
            try:
                req = SweepRequest.from_json(e["request"])
                res = ST.result_from_json(e["result"])
            except (TypeError, ValueError, KeyError):
                continue
            t = Ticket(e["id"], int(e.get("seq", 0)), req, self,
                       client_id=e.get("client_id"))
            t.signature = e.get("signature")
            t.state = DONE
            t.progress = float(res.stats.get("fraction_complete", 1.0))
            t._result = res
            t._done.set()
            self._remember(t)
            self.counters["recovered_finished"] += 1

    def _remember(self, t: Ticket) -> None:
        with self._lock:
            self._tickets[t.id] = t
            if t.client_id is not None:
                self._by_client[t.client_id] = t
            while len(self._tickets) > self._keep_finished:
                for tid, old in self._tickets.items():
                    if old.done():
                        del self._tickets[tid]
                        if old.client_id is not None and \
                                self._by_client.get(old.client_id) \
                                is old:
                            del self._by_client[old.client_id]
                        break
                else:
                    break       # nothing evictable: keep them all

    def _cancel_queued(self, t: Ticket) -> None:
        if self._queue.remove(t):
            self._finish(t, CANCELLED,
                         error=CancelledError(
                             f"request {t.id} cancelled before "
                             f"execution"))

    def _finish(self, t: Ticket, state: str, result=None, error=None,
                journal_state: Optional[str] = None) -> None:
        t.state = state
        t._result = result
        t._error = error
        with self._lock:
            key = {DONE: "completed", FAILED: "failed",
                   CANCELLED: "cancelled"}[state]
            self.counters[key] += 1
        self._journal(t, state=journal_state)
        t._done.set()
        with t._snap_cond:          # wake watchers blocked on progress
            t._snap_cond.notify_all()

    # -- internals: planning --------------------------------------------

    def _plan_for(self, req: SweepRequest) -> ST.StreamPlan:
        """Resolve (or fetch) the content-signature-keyed plan — the
        LRU that keeps :func:`repro_torch.core.backend.cached_step`
        hitting across requests for byte-identical jobs.  The plan is
        one shard on the service's device (an automatic device list
        would shard the ``"torch"`` backend over every visible card and
        change the chunk geometry the worker processes rebuild)."""
        plan = ST.plan_stream(**plan_kwargs(req), device=self.device,
                              devices=(self.device,))
        with self._lock:
            cached = self._plans.get(plan.signature)
            if cached is not None:
                self.counters["plan_hits"] += 1
                self._plans.move_to_end(plan.signature)
                return cached
            self.counters["plan_misses"] += 1
            self._plans[plan.signature] = plan
            while len(self._plans) > self._plan_cache_size:
                self._plans.popitem(last=False)
        return plan

    # -- internals: execution -------------------------------------------

    def _run_worker(self) -> None:
        while not self._shutdown.is_set():
            if self._paused.is_set():
                time.sleep(self._poll_s)
                continue
            compat = self._compatible if self._fuse else None
            batch = self._queue.take_batch(timeout=self._poll_s,
                                           compatible=compat,
                                           max_batch=self._max_fuse)
            if batch:
                try:
                    self._execute(batch)
                finally:
                    # Return the claimed in-flight slots so per-tenant
                    # pending caps see the true outstanding count.
                    for t in batch:
                        self._queue.release(t.tenant)

    def _compatible(self, head: Ticket, other: Ticket) -> bool:
        return (head.request.fuse and other.request.fuse
                and not other.cancelled
                and _fusable(head.request, other.request))

    def _execute(self, batch: list) -> None:
        members = []
        for t in batch:
            if t.cancelled:
                self._finish(t, CANCELLED,
                             error=CancelledError(
                                 f"request {t.id} cancelled before "
                                 f"execution"))
            else:
                members.append(t)
        if not members:
            return
        fused = (_fused_request([t.request for t in members])
                 if len(members) > 1 else members[0].request)
        try:
            plan = self._plan_for(fused)
        except Exception as e:
            for t in members:
                self._finish(t, FAILED, error=e)
            return
        deadline = Deadline.earliest(*[t.deadline for t in members])
        cause = {"why": None}

        def should_stop() -> bool:
            if deadline.expired():
                cause["why"] = "deadline"
                return True
            if all(t.cancelled for t in members):
                cause["why"] = "cancel"
                return True
            if self._shutdown.is_set():
                cause["why"] = "shutdown"
                return True
            return False

        def on_progress(frac: float) -> None:
            for t in members:
                t.progress = frac

        def on_snapshot(snap: dict) -> None:
            for t in members:
                t._update_snapshot(snap)

        for t in members:
            t.state = RUNNING
            t.signature = plan.signature
            self._journal(t)
        with self._lock:
            self.counters["executions"] += 1
            if len(members) > 1:
                self.counters["fused_requests"] += len(members)
            for t in members:
                self._running[t.id] = t
        use_pool = (self._pool is not None
                    and self._fault_injector is None
                    and all(t.request.deadline_s is None
                            for t in members))
        if use_pool:
            try:
                fused.to_json()
            except TypeError:
                use_pool = False    # volatile request: run in-process
        try:
            if use_pool:
                res = self._execute_pooled(fused, plan, should_stop,
                                           cause, on_progress,
                                           on_snapshot)
            else:
                res = ST.stream_grid(
                    plan=plan, prefetch=self._prefetch,
                    checkpoint_dir=(self._ckpt_dir(plan.signature)
                                    if self.spool_dir is not None
                                    else None),
                    checkpoint_every_s=self._ckpt_every_s,
                    checkpoint_every_steps=self._ckpt_every_steps,
                    checkpoint_keep=self._ckpt_keep,
                    retry_policy=self._retry_policy,
                    fault_injector=self._fault_injector,
                    should_stop=should_stop, on_progress=on_progress,
                    on_snapshot=on_snapshot,
                    snapshot_every_s=self._snapshot_every_s)
        except _PoolPreempted:
            # Shutdown mid-pooled-run: leave the tickets unfinished —
            # close() fails them with journal state RUNNING, and a new
            # service over this spool reattaches to the lease board.
            return
        except _PoolCancelled:
            for t in members:
                self._finish(t, CANCELLED,
                             error=CancelledError(
                                 f"request {t.id} cancelled during "
                                 f"pooled execution"))
            return
        except Exception as e:
            for t in members:
                self._finish(t, FAILED, error=e)
            return
        finally:
            with self._lock:
                for t in members:
                    self._running.pop(t.id, None)
        with self._lock:
            for key in ("retries", "restarts", "chunks_reissued",
                        "elastic_replans", "checkpoints_written",
                        "stragglers", "step_timeouts"):
                self.counters[key] += int(res.stats.get(key, 0))
            if res.partial and cause["why"] == "deadline":
                self.counters["deadline_expired"] += len(members)
        preempted = res.partial and cause["why"] == "shutdown"
        for t in members:
            out = (self._member_result(fused, plan, res, t.request,
                                       len(members))
                   if len(members) > 1 else res)
            t.progress = res.stats["fraction_complete"]
            if t.cancelled:
                self._finish(t, CANCELLED, result=out)
            else:
                # A shutdown-preempted request still delivers its
                # partial snapshot, but its journal stays RUNNING so a
                # later service over this spool resumes it to
                # completion from the terminal checkpoint.
                self._finish(t, DONE, result=out,
                             journal_state=(RUNNING if preempted
                                            else None))

    def _execute_pooled(self, fused: SweepRequest, plan: ST.StreamPlan,
                        should_stop, cause, on_progress,
                        on_snapshot) -> ST.StreamResult:
        """Run one (possibly fused) request on the worker pool: split
        the flat-index space into chunk-range leases on the shared
        spool, let the workers stream them, fold the parts into one
        bitwise-exact result (:func:`repro_torch.core.stream.
        merge_results`).
        The coordinator only polls the lease board: it respawns dead
        workers (whose leases are reclaimed from their own carry
        checkpoints) and synthesizes progress snapshots from finished
        parts."""
        from ..runtime import workers as WK
        handle = WK.dispatch_job(
            self.spool_dir, fused, plan=plan,
            n_leases=(self._lease_splits
                      if self._lease_splits is not None
                      else max(2 * self._pool.n, 4)),
            checkpoint_every_steps=self._ckpt_every_steps,
            prefetch=self._prefetch)
        last_snap = 0.0
        while True:
            st = handle.poll()
            if st["failed"]:
                handle.cancel()
                errs = "; ".join(
                    f"lease {ls['i']} [{ls['start']}, {ls['stop']}): "
                    f"{ls.get('error')}" for ls in st["failed"])
                raise RuntimeError(f"pooled execution of "
                                   f"{plan.signature[:12]} failed: {errs}")
            if st["done"]:
                break
            if should_stop():
                if cause["why"] == "cancel":
                    handle.cancel()
                    self._await_quiesce(handle)
                    raise _PoolCancelled()
                raise _PoolPreempted()
            self._pool.ensure()
            on_progress(float(st["fraction"]))
            now = time.monotonic()
            if now - last_snap >= self._snapshot_every_s:
                last_snap = now
                on_snapshot(handle.snapshot(st))
            time.sleep(self._poll_s)
        res = handle.result()
        with self._lock:
            self.counters["pooled_executions"] += 1
            self.counters["leases_reissued"] += sum(
                max(0, int(ls["attempt"]) - 1) for ls in st["leases"])
        return res

    def _await_quiesce(self, handle, timeout: float = 30.0) -> None:
        """After a pooled cancel: wait (bounded) until no lease is
        still leased — workers notice the cancel flag within one
        heartbeat cycle and abort cooperatively."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if handle.poll()["states"].get("leased", 0) == 0:
                return
            time.sleep(self._poll_s)

    @staticmethod
    def _member_result(fused: SweepRequest, plan: ST.StreamPlan,
                       res: ST.StreamResult, req: SweepRequest,
                       n_members: int) -> ST.StreamResult:
        """Slice one member's exact deliverables out of the fused
        result: per-channel argmin/count/bounds dicts restrict to the
        member's tracked fields, top-k rows select the member's
        objectives (first ``top_k`` columns of the fused k-best
        table), and the shared front is handed over only when the
        member's objective tuple equals the fused tuple (otherwise the
        member asked for ``need_front=False`` and gets an empty
        front)."""
        obj_idx = [fused.objectives.index(o) for o in req.objectives]
        mfields = _request_fields(req, SW.kernel_fields(plan.S))
        if tuple(req.objectives) == tuple(fused.objectives):
            front_i, front_v = res.front_indices, res.front_values
        else:
            front_i = np.empty((0,), np.int64)
            front_v = np.empty((0, len(req.objectives)))
        hist = None
        if res.hist is not None:
            hist = {f: res.hist[f] for f in req.objectives}
        stats = dict(res.stats, fused_members=float(n_members))
        return dataclasses.replace(
            res,
            objectives=tuple(req.objectives),
            maximize=tuple(o for o in req.objectives
                           if o in req.maximize),
            min_val={f: res.min_val[f] for f in mfields},
            min_idx={f: res.min_idx[f] for f in mfields},
            finite_counts={f: res.finite_counts[f] for f in mfields},
            channel_min={f: res.channel_min[f] for f in mfields},
            channel_max={f: res.channel_max[f] for f in mfields},
            topk_idx=res.topk_idx[obj_idx][:, :req.top_k],
            topk_val=res.topk_val[obj_idx][:, :req.top_k],
            front_indices=front_i, front_values=front_v,
            hist=hist, stats=stats)


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.service
# ---------------------------------------------------------------------------


def _result_summary(t: Ticket) -> dict:
    out = t.summary()
    if t.state == DONE and t._result is not None:
        r = t._result
        field = r.objectives[0]
        try:
            out["argmin"] = {k: (float(v) if isinstance(v, (int, float))
                                 else str(v))
                             for k, v in r.argmin(field).items()}
        except ValueError as e:     # all-infeasible (or empty partial)
            out["argmin_error"] = str(e)
        out["fraction_complete"] = r.stats["fraction_complete"]
        out["configs_per_s"] = round(r.stats["configs_per_s"], 1)
    elif t._error is not None:
        out["error"] = str(t._error)
    return out


def _serve(svc: "SweepService", listen: Optional[str],
           unix: Optional[str],
           auth_token: Optional[str] = None) -> int:
    """Networked mode: serve ``svc`` over TCP or a Unix socket until
    SIGTERM/SIGINT, then drain gracefully.  Prints one JSON ready line
    (``{"listening": <address>}``) once the socket is bound, so
    supervisors and tests can wait for startup."""
    import signal

    from ..runtime.transport import SweepServer, parse_address

    if unix is not None:
        server = SweepServer(svc, unix_path=unix, own_service=True,
                             auth_token=auth_token)
    else:
        kind, host, port = parse_address(listen)
        if kind != "tcp":
            raise SystemExit(f"--listen wants HOST:PORT, got {listen!r}")
        server = SweepServer(svc, host=host, port=port,
                             own_service=True, auth_token=auth_token)
    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())
    server.start()
    print(json.dumps({"listening": server.address}), flush=True)
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        server.close(drain=True)
    print(json.dumps({"health": svc.health()}))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Spool-backed sweep server.  Batch mode (default): recover + run
    journaled requests, then requests from ``--requests`` (a JSON-lines
    file of :meth:`SweepRequest.to_json` payloads), print one JSON
    summary per finished request plus the final health snapshot.
    Networked mode (``--listen HOST:PORT`` or ``--unix PATH``): serve
    the framed-JSON protocol of :mod:`repro_torch.runtime.transport`
    until SIGTERM/SIGINT, then drain gracefully.  ``--device`` (default
    ``cuda``) is where requests run; ``--device cpu`` runs the plain
    PyTorch path."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Persistent crash-safe sweep server over "
                    "repro_torch.core.stream.stream_grid.")
    ap.add_argument("--device", default="cuda",
                    help="device in-process requests run on (default "
                         "cuda; 'cpu' runs the plain PyTorch path); "
                         "worker processes take one card each")
    ap.add_argument("--spool", default=None,
                    help="spool directory (journal + checkpoints); "
                         "restarting over the same spool resumes "
                         "unfinished requests bitwise-exactly")
    ap.add_argument("--requests", default=None,
                    help="JSON-lines file of SweepRequest payloads to "
                         "submit")
    ap.add_argument("--capacity", type=int, default=16)
    ap.add_argument("--checkpoint-every-steps", type=int, default=None)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request result timeout")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve the framed-JSON protocol on a TCP "
                         "socket (port 0 picks a free port, printed "
                         "in the ready line)")
    ap.add_argument("--unix", default=None, metavar="PATH",
                    help="serve on a Unix-domain socket at PATH")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME:WEIGHT[:MAX_PENDING]",
                    help="register a tenant fairness policy "
                         "(repeatable)")
    ap.add_argument("--workers", type=int, default=0,
                    help="spawn N worker processes over the spool and "
                         "run eligible requests via chunk-range "
                         "leasing (0 = in-process execution)")
    ap.add_argument("--worker-ttl-s", type=float, default=10.0,
                    help="lease heartbeat TTL: a worker silent this "
                         "long is presumed dead and its range is "
                         "reissued from its carry checkpoint")
    ap.add_argument("--lease-splits", type=int, default=None,
                    help="lease count per job (default 2x workers, "
                         "min 4)")
    ap.add_argument("--auth-token", default=None,
                    help="shared secret for the socket handshake "
                         "(clients must pass auth=; unauthenticated "
                         "connections are rejected before any JSON "
                         "is parsed)")
    args = ap.parse_args(argv)

    svc = SweepService(spool_dir=args.spool, capacity=args.capacity,
                       checkpoint_every_steps=args.checkpoint_every_steps,
                       workers=args.workers,
                       worker_ttl_s=args.worker_ttl_s,
                       lease_splits=args.lease_splits,
                       device=args.device)
    for spec in args.tenant:
        parts = spec.split(":")
        svc.set_tenant(parts[0],
                       weight=float(parts[1]) if len(parts) > 1 else 1.0,
                       max_pending=(int(parts[2]) if len(parts) > 2
                                    else None))
    if args.listen or args.unix:
        return _serve(svc, args.listen, args.unix,
                      auth_token=args.auth_token)
    try:
        tickets = svc.tickets()     # recovered work first
        if args.requests:
            with open(args.requests) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    tickets.append(svc.submit(
                        SweepRequest.from_json(json.loads(line))))
        for t in tickets:
            try:
                t.result(args.timeout_s)
            except Exception:
                pass
            print(json.dumps(_result_summary(t)))
        print(json.dumps({"health": svc.health()}))
    finally:
        svc.close()
    return 0


if __name__ == "__main__":      # pragma: no cover
    sys.exit(main())
