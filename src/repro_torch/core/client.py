"""Reconnecting, idempotent client for the networked sweep service (the
port's own copy of the reference package's ``core/client.py``).

:class:`SweepClient` talks the framed-JSON protocol of
:class:`repro_torch.runtime.transport.SweepServer` and makes every request
path survive the failures a long outer search loop (the SplitNets-
style co-design driver) actually hits:

* **Idempotent submits** — every submit carries a client-generated
  request id (``uuid4`` unless you pass one).  The service
  deduplicates the id against its live index *and its journal*, so a
  retried submit after a dropped connection — or a full server
  SIGKILL + restart over the same spool — attaches to the existing
  ticket (or its recovered finished result) instead of executing
  twice.  Blind retry is therefore always safe.
* **Automatic reconnect** — every call runs a reconnect-and-resend
  loop with capped exponential backoff plus full jitter
  (``backoff_s`` doubling to ``backoff_max_s`` over
  ``reconnect_timeout_s``); in-flight ``result()`` waits re-attach by
  resubmitting the idempotent id and resuming the watch stream.
* **Explicit backpressure** — an overloaded server answers with a
  ``backpressure`` error frame; the client re-raises it as the same
  :class:`repro_torch.runtime.admission.BackpressureError` the in-process
  API throws, with ``queue_depth`` / ``capacity`` / ``retry_after_s``
  / ``tenant`` carried over the wire.  Overload is *not* retried
  automatically — the retry-after hint is the caller's pacing signal.
* **Incremental progress** — ``result(on_progress=...)`` subscribes
  to the server's consistent prefix snapshots (``fraction_complete``,
  running per-objective best, front size) while waiting, and the
  final result decodes through the exact JSON codec
  (:func:`repro_torch.core.stream.result_from_json`) — bitwise-identical to
  the in-process path.

Server-side request failures surface as :class:`RemoteError` (or the
mapped :class:`~repro_torch.core.service.CancelledError` /
:class:`~repro_torch.core.service.ServiceClosedError`); connection loss
that outlasts ``reconnect_timeout_s`` raises ``ConnectionError``.
"""

from __future__ import annotations

import queue as _queue
import random
import socket
import threading
import time
import uuid
from typing import Callable, Optional, Sequence, Union

from ..runtime.admission import BackpressureError
from ..runtime.transport import AuthenticationError  # re-export
from ..runtime import transport as T
from . import service as CS
from . import stream as ST


class RemoteError(RuntimeError):
    """The server answered with an error frame (``kind`` preserves the
    wire error kind)."""

    def __init__(self, kind: str, message: str):
        self.kind = kind
        super().__init__(f"{kind}: {message}")


def _raise_error_frame(frame: dict) -> None:
    kind = frame.get("error")
    msg = frame.get("message", "")
    if kind == "backpressure":
        raise BackpressureError(
            int(frame.get("queue_depth", 0)),
            int(frame.get("capacity", 0)),
            reason=msg or "admission queue full",
            tenant=frame.get("tenant"),
            retry_after_s=frame.get("retry_after_s"))
    if kind == "cancelled":
        raise CS.CancelledError(msg)
    if kind == "closed":
        raise CS.ServiceClosedError(msg)
    if kind == "timeout":
        raise TimeoutError(msg)
    if kind == "bad_request":
        raise ValueError(msg)
    raise RemoteError(kind or "internal", msg)


class RemoteTicket:
    """Client-side handle to one submitted request — the networked
    mirror of :class:`repro_torch.core.service.Ticket`.  ``client_id`` is
    the idempotency key: every retry path resubmits it, and the
    service guarantees at-most-one execution per id."""

    def __init__(self, client: "SweepClient", request: CS.SweepRequest,
                 client_id: str, ticket_id: str, state: str):
        self._client = client
        self.request = request
        self.client_id = client_id
        self.id = ticket_id
        self.state = state

    def status(self) -> dict:
        out = self._client._call({"op": "status", "id": self.id})
        self.state = out.get("state", self.state)
        return out

    def cancel(self) -> dict:
        return self._client._call({"op": "cancel", "id": self.id})

    def result(self, timeout: Optional[float] = None,
               on_progress: Optional[Callable] = None
               ) -> ST.StreamResult:
        """Block for the outcome, surviving connection loss and server
        restarts: each (re)attempt resubmits the idempotent
        ``client_id`` (attaching to the live ticket, the recovered
        journal entry, or a fresh execution resumed from the
        checkpoint spool) and then watches the progress stream.
        ``on_progress`` receives each consistent prefix snapshot dict.
        The decoded final result is bitwise-identical to the
        in-process path."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        wire_before = self._client.counters.get("bytes_in", 0)
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"request {self.id} not finished within {timeout}s")
            try:
                # Re-attach first: the idempotent resubmit finds the
                # live ticket, the journal-recovered finished result,
                # or (after an unplanned kill) re-admits the request
                # to resume from its checkpoint spool.
                sub = self._client._call(
                    {"op": "submit",
                     "request": self.request.to_json(),
                     "client_id": self.client_id})
                self.id = sub["id"]
                self.state = sub.get("state", self.state)
                final = self._client._call(
                    {"op": "watch", "id": self.id,
                     "timeout": remaining},
                    on_event=self._on_event(on_progress))
            except ConnectionError:
                # _call already spent a full reconnect budget; without
                # a result deadline that is the giving-up point, with
                # one we keep re-attaching while time remains.
                if deadline is None or time.monotonic() >= deadline:
                    raise
                self._client._backoff_once()
                continue
            except RemoteError as e:
                if e.kind == "not_found":
                    # The server lost the ticket (restart without a
                    # spool): loop back to the idempotent resubmit.
                    self._client._backoff_once()
                    continue
                raise
            self.state = final.get("state", self.state)
            res = ST.result_from_json(final["result"])
            # Wire bytes this wait cost (submit + watch stream + final
            # frame) — the delta-streaming savings show up right here.
            res.stats["watch_wire_bytes"] = float(
                self._client.counters.get("bytes_in", 0) - wire_before)
            return res

    def _on_event(self, on_progress):
        held = {"snap": None}

        def handle(frame: dict) -> None:
            self.state = frame.get("state", self.state)
            if "snapshot" in frame:
                held["snap"] = dict(frame["snapshot"])
            elif "delta" in frame:
                # Per-chunk delta frames: fold into the held baseline
                # (the server always re-baselines a fresh watch, so
                # the first frame is never a delta).
                held["snap"] = ST.apply_result_delta(held["snap"],
                                                     frame["delta"])
            else:
                return
            if on_progress is not None:
                on_progress(held["snap"])
        return handle


class SweepClient:
    """Socket client for a :class:`~repro_torch.runtime.transport.
    SweepServer` at ``address`` (``"host:port"`` for TCP, a filesystem
    path for a Unix socket) — or a *sequence* of replica addresses,
    in which case connection failures rotate through them (failover)
    and :meth:`submit` can hedge across them (``hedge_s=``).

    One connection, created lazily and replaced transparently: every
    call retries connect/send/receive failures with capped exponential
    backoff + full jitter until ``reconnect_timeout_s`` is exhausted
    (then ``ConnectionError``).  ``heartbeat_grace_s`` bounds how long
    a blocking call waits without hearing *anything* (data, progress
    or heartbeat frames) before declaring the connection dead — keep
    it a few multiples of the server's ``heartbeat_s``.  ``auth``
    answers the server's HMAC challenge (see ``--auth-token``); a
    missing or rejected token raises :class:`AuthenticationError`
    immediately — credentials are never retried.  Thread-safe per
    instance only if each thread uses its own client.
    """

    def __init__(self, address: Union[str, Sequence[str]],
                 connect_timeout_s: float = 5.0,
                 reconnect_timeout_s: float = 60.0,
                 backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 heartbeat_grace_s: float = 10.0,
                 max_frame: int = T.MAX_FRAME,
                 auth: Optional[str] = None,
                 rng: Optional[random.Random] = None):
        addrs = ([address] if isinstance(address, str)
                 else list(address))
        if not addrs:
            raise ValueError("need at least one server address")
        self.addresses = tuple(addrs)
        self.address = addrs[0]
        self._addr_i = 0
        self._connect_timeout_s = float(connect_timeout_s)
        self._reconnect_timeout_s = float(reconnect_timeout_s)
        self._backoff_s = float(backoff_s)
        self._backoff_max_s = float(backoff_max_s)
        self._grace_s = float(heartbeat_grace_s)
        self._max_frame = int(max_frame)
        self._auth = auth
        self._rng = rng if rng is not None else random.Random()
        self._sock: Optional[socket.socket] = None
        self._rid = 0
        self._attempt = 0
        self.counters = {"reconnects": 0, "retries": 0, "calls": 0,
                         "failovers": 0, "hedged_submits": 0,
                         "bytes_in": 0}

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "SweepClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- public API --------------------------------------------------------

    def ping(self) -> dict:
        return self._call({"op": "ping"})

    def health(self) -> dict:
        return self._call({"op": "health"})["health"]

    def submit(self, request: CS.SweepRequest,
               client_id: Optional[str] = None,
               hedge_s: Optional[float] = None) -> RemoteTicket:
        """Submit one request; returns a :class:`RemoteTicket`.
        ``client_id`` defaults to a fresh ``uuid4`` — keep the
        returned ticket's id to re-attach from another process.
        Raises :class:`~repro_torch.runtime.admission.BackpressureError`
        (with the server's retry-after hint) on overload — overload is
        never retried blindly.

        ``hedge_s`` (with multiple replica addresses) *hedges* the
        submit: the primary gets a head start of ``hedge_s`` seconds,
        then each further replica is raced in ``hedge_s`` stagger; the
        first answer wins.  All legs share one idempotent
        ``client_id``, so the service executes at most once no matter
        how many legs land — the loser is deduplicated, never run."""
        cid = client_id or f"cli-{uuid.uuid4().hex}"
        payload = {"op": "submit", "request": request.to_json(),
                   "client_id": cid}
        if hedge_s is not None and len(self.addresses) > 1:
            out = self._hedged_call(payload, float(hedge_s))
        else:
            out = self._call(payload)
        return RemoteTicket(self, request.normalized(), cid,
                            out["id"], out.get("state", "queued"))

    def _hedged_call(self, payload: dict, hedge_s: float) -> dict:
        """Race one call across every replica address with ``hedge_s``
        stagger; first successful response wins, later legs are
        abandoned (their submits deduplicate server-side).  Raises the
        first leg error only when every leg failed."""
        self.counters["hedged_submits"] += 1
        results: "_queue.Queue" = _queue.Queue()
        won = threading.Event()

        def leg(addr: str, delay: float) -> None:
            if delay > 0 and won.wait(delay):
                results.put(("skipped", None))
                return
            try:
                with SweepClient(
                        addr, auth=self._auth,
                        connect_timeout_s=self._connect_timeout_s,
                        reconnect_timeout_s=self._reconnect_timeout_s,
                        backoff_s=self._backoff_s,
                        backoff_max_s=self._backoff_max_s,
                        heartbeat_grace_s=self._grace_s,
                        max_frame=self._max_frame) as c:
                    results.put(("ok", c._call(dict(payload))))
            except Exception as e:
                results.put(("err", e))

        threads = [threading.Thread(target=leg, args=(a, i * hedge_s),
                                    daemon=True)
                   for i, a in enumerate(self.addresses)]
        for th in threads:
            th.start()
        first_err: Optional[Exception] = None
        for _ in threads:
            kind, val = results.get()
            if kind == "ok":
                won.set()
                return val
            if kind == "err" and first_err is None:
                first_err = val
        won.set()
        raise first_err if first_err is not None else ConnectionError(
            f"no replica of {self.addresses} answered the hedged "
            f"submit")

    def status(self, ticket_id: str) -> dict:
        return self._call({"op": "status", "id": ticket_id})

    def cancel(self, ticket_id: str) -> dict:
        return self._call({"op": "cancel", "id": ticket_id})

    def result(self, ticket: RemoteTicket,
               timeout: Optional[float] = None,
               on_progress: Optional[Callable] = None
               ) -> ST.StreamResult:
        return ticket.result(timeout=timeout, on_progress=on_progress)

    # -- internals: one call = send + frames until non-hb reply ----------

    def _connect(self) -> socket.socket:
        kind, host, port = T.parse_address(self.address)
        if kind == "unix":
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            target: object = host
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            target = (host, port)
        s.settimeout(self._connect_timeout_s)
        s.connect(target)
        try:
            T.client_handshake(s, auth=self._auth)
        except BaseException:
            s.close()
            raise
        s.settimeout(self._grace_s)
        return s

    def _rotate(self) -> None:
        """After a connection failure: point at the next replica
        address (no-op with a single address)."""
        if len(self.addresses) > 1:
            self._addr_i = (self._addr_i + 1) % len(self.addresses)
            self.address = self.addresses[self._addr_i]
            self.counters["failovers"] += 1

    def _backoff_once(self) -> None:
        """One capped-exponential, full-jitter sleep (shared by the
        call loop and :meth:`RemoteTicket.result`'s re-attach loop)."""
        delay = min(self._backoff_max_s,
                    self._backoff_s * (2.0 ** self._attempt))
        self._attempt += 1
        self.counters["retries"] += 1
        time.sleep(self._rng.uniform(0.0, delay))

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, payload: dict,
              on_event: Optional[Callable] = None) -> dict:
        """Send one request and return its final response frame,
        reconnecting and resending on connection failure until
        ``reconnect_timeout_s`` is exhausted.  Heartbeat frames reset
        the liveness clock; ``on_event`` sees every intermediate frame
        (progress + heartbeats).  Only safe because every operation is
        idempotent server-side (submits via client ids, the rest
        read-only or at-most-once by nature)."""
        self.counters["calls"] += 1
        give_up = time.monotonic() + self._reconnect_timeout_s
        self._attempt = 0
        while True:
            final = None
            try:
                if self._sock is None:
                    self._sock = self._connect()
                    self.counters["reconnects"] += 1
                self._rid += 1
                rid = f"r{self._rid}"
                self._sock.sendall(
                    T.encode_frame(dict(payload, rid=rid)))
                while final is None:
                    frame = T.read_frame(self._sock, self._max_frame,
                                         self.counters)
                    if frame is None:
                        raise ConnectionError("server closed the "
                                              "connection")
                    if frame.get("rid") not in (None, rid):
                        continue        # stale frame from a prior call
                    if on_event is not None:
                        on_event(frame)
                    if frame.get("hb") or "snapshot" in frame \
                            or "delta" in frame:
                        continue        # liveness / streaming frames
                    final = frame
            except AuthenticationError:
                self._drop()
                raise           # a bad credential never heals by retry
            except (ConnectionError, BrokenPipeError, socket.timeout,
                    OSError) as e:
                self._drop()
                self._rotate()
                if time.monotonic() >= give_up:
                    raise ConnectionError(
                        f"could not reach sweep server at "
                        f"{self.address} within "
                        f"{self._reconnect_timeout_s}s: {e}") from e
                self._backoff_once()
                continue
            # Error frames raise OUTSIDE the except scope above: a
            # server-reported TimeoutError is an OSError subclass and
            # must never be mistaken for a connection failure.
            self._attempt = 0
            if final.get("error"):
                _raise_error_frame(final)
            return final
