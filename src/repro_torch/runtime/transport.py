"""Networked transport for the sweep service: framed JSON over sockets
(the port's own copy of the reference package's ``runtime/transport.py``;
the wire protocol is the same byte for byte).

:class:`SweepServer` puts a :class:`repro_torch.core.service.SweepService`
on a TCP or Unix-domain socket — the network face of ROADMAP item 2 —
with a deliberately tiny, dependency-free wire protocol:

* **Framing** — every message is a 4-byte big-endian length prefix
  followed by that many bytes of UTF-8 JSON (Python-extended: ``NaN``
  / ``Infinity`` tokens allowed, so result payloads round-trip
  non-finite floats).  Oversized frames are rejected before allocation
  (``max_frame``), so a corrupt or hostile length prefix cannot OOM
  the server.
* **Connections** — one accept thread plus one reader thread per
  connection; each request frame is handled inline on its connection
  thread and every response frame echoes the request's ``rid``
  correlation id.  A connection failure affects only that client:
  its requests stay admitted and journaled server-side, which is what
  makes the client's idempotent resubmit safe.
* **Liveness** — blocking operations (``result``, ``watch``) emit
  ``{"hb": true}`` heartbeat frames every ``heartbeat_s`` while the
  request runs, so a client can distinguish a slow sweep from a dead
  server without an out-of-band channel; ``ping`` gives an explicit
  round-trip probe.
* **Graceful shutdown** — :meth:`SweepServer.close` stops accepting,
  rejects new submits with a ``shutting_down`` error (retry-after
  carried), optionally drains the admitted backlog to completion, and
  only then closes the listener and connections — in-flight requests
  are never dropped by a planned shutdown.

Operations (request ``{"op": ..., "rid": ...}`` → response frames):

=========  ==========================================================
``ping``    liveness probe → ``{"pong": true}``
``submit``  ``{"request": <SweepRequest.to_json>, "client_id": ...}``
            → ``{"id", "state", "deduped"}``; overload → an ``error``
            frame of kind ``backpressure`` carrying ``queue_depth``,
            ``capacity``, ``retry_after_s`` and ``tenant``
``status``  ``{"id"}`` → the ticket summary
``result``  ``{"id", "timeout"}`` → heartbeats, then
            ``{"done": true, "state", "result": <result_to_json>}``
``watch``   ``{"id", "last_seq"}`` → ``{"snapshot": <snapshot>,
            "seq"}`` frames as consistent prefix snapshots land
            (plus heartbeats), then the final ``done`` frame
``cancel``  ``{"id"}`` → ``{"state": ...}`` (cooperative)
``health``  → the service health dict
=========  ==========================================================

Error frames are ``{"error": <kind>, "message": ...}`` with kinds
``backpressure``, ``bad_request``, ``not_found``, ``cancelled``,
``closed``, ``shutting_down`` and ``internal`` —
:class:`repro_torch.core.client.SweepClient` maps them back to the
exceptions the in-process API raises.

Protocol 2 additions:

* **Greeting + HMAC handshake** — immediately after accept the server
  sends a fixed 21-byte greeting ``b"SWG2" + flags + nonce16``.  When
  the server holds an ``auth_token`` (flag ``0x01``), the client must
  answer with ``HMAC-SHA256(token, nonce)`` (32 raw bytes) before any
  frame; the server replies one verdict byte and drops unauthenticated
  connections *before parsing any JSON*.  Tokens never travel on the
  wire and every connection gets a fresh nonce (no replay).
* **Delta watch frames** — the first ``watch`` progress frame on a
  connection is a full ``{"snapshot", "seq"}`` baseline; subsequent
  ones are ``{"delta", "seq"}`` per-chunk argmin/front deltas
  (:func:`repro_torch.core.stream.result_delta_to_json`), which the client
  folds back with :func:`~repro_torch.core.stream.apply_result_delta`.  The
  final result still travels as a full exact payload.
* **Wire accounting** — ``bytes_in`` / ``bytes_out`` plus
  ``watch_snapshot_bytes`` / ``watch_delta_bytes`` counters, surfaced
  under ``health()["transport"]``.
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import json
import os
import secrets
import socket
import struct
import threading
import time
from typing import Optional

from .admission import BackpressureError

#: Wire protocol version, echoed in ``ping`` responses.
PROTOCOL = 2

#: Greeting magic: "SWeep Grid" protocol 2.
MAGIC = b"SWG2"
_FLAG_AUTH = 0x01
_NONCE_LEN = 16
_MAC_LEN = 32
_HANDSHAKE_TIMEOUT_S = 10.0


class AuthenticationError(RuntimeError):
    """Raised client-side when the handshake fails: the server demands
    a token the client does not hold, or rejected the one it sent.
    Deliberately *not* a :class:`ConnectionError` — the client's
    reconnect loop must not retry a hopeless credential."""

#: Default cap on one frame's payload (bytes) — large enough for any
#: realistic result (fronts are O(10^3) rows), small enough that a
#: corrupt length prefix cannot balloon allocation.
MAX_FRAME = 64 * 1024 * 1024

_LEN = struct.Struct(">I")


def encode_frame(payload: dict) -> bytes:
    """Length-prefixed UTF-8 JSON encoding of one message."""
    body = json.dumps(payload, allow_nan=True,
                      separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame of {len(body)} bytes exceeds the "
                         f"{MAX_FRAME}-byte protocol cap")
    return _LEN.pack(len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket,
               max_frame: int = MAX_FRAME,
               stats: Optional[dict] = None) -> Optional[dict]:
    """Read one framed JSON message (``None`` on clean EOF between
    frames; :class:`ConnectionError` on a torn frame or oversized
    length prefix).  ``stats`` (any dict) gets its ``"bytes_in"`` key
    bumped by the frame's wire size — both endpoints use this for the
    delta-streaming accounting."""
    try:
        head = sock.recv(_LEN.size)
    except (TimeoutError, socket.timeout):
        raise
    if not head:
        return None
    if len(head) < _LEN.size:
        head += _recv_exact(sock, _LEN.size - len(head))
    (n,) = _LEN.unpack(head)
    if n > max_frame:
        raise ConnectionError(
            f"peer announced a {n}-byte frame (cap {max_frame}) — "
            f"corrupt stream or protocol mismatch")
    if stats is not None:
        stats["bytes_in"] = stats.get("bytes_in", 0) + _LEN.size + n
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


def client_handshake(sock: socket.socket,
                     auth: Optional[str] = None) -> None:
    """Client side of the protocol-2 greeting: consume the 21-byte
    ``MAGIC + flags + nonce`` greeting and, when the server demands
    auth, answer the HMAC-SHA256 challenge and check the verdict byte.
    Raises :class:`AuthenticationError` on a missing/rejected token and
    :class:`ConnectionError` on a non-sweep peer."""
    old = sock.gettimeout()
    sock.settimeout(_HANDSHAKE_TIMEOUT_S)
    try:
        head = _recv_exact(sock, len(MAGIC) + 1 + _NONCE_LEN)
        if head[:len(MAGIC)] != MAGIC:
            raise ConnectionError(
                f"peer is not a protocol-{PROTOCOL} sweep server "
                f"(greeting {head[:4]!r})")
        flags = head[len(MAGIC)]
        nonce = head[len(MAGIC) + 1:]
        if flags & _FLAG_AUTH:
            if auth is None:
                raise AuthenticationError(
                    "server requires an auth token — pass "
                    "SweepClient(auth=...) / --auth-token")
            sock.sendall(hmac.new(auth.encode("utf-8"), nonce,
                                  hashlib.sha256).digest())
            if _recv_exact(sock, 1) != b"\x01":
                raise AuthenticationError(
                    "server rejected the auth token")
    finally:
        sock.settimeout(old)


def parse_address(address: str):
    """``"host:port"`` → ``("tcp", host, port)``; anything else is a
    Unix-domain socket path → ``("unix", path, None)``."""
    if ":" in address and not address.startswith(("/", ".")):
        host, _, port = address.rpartition(":")
        return ("tcp", host or "127.0.0.1", int(port))
    return ("unix", address, None)


class SweepServer:
    """Serve one :class:`~repro_torch.core.service.SweepService` over a
    socket.

    Exactly one of ``(host, port)`` or ``unix_path`` selects the
    listener.  ``start()`` (or entering the context manager) binds and
    spawns the accept thread; :attr:`address` is the bound endpoint
    (useful with ``port=0``).  The server owns no service lifecycle by
    default — pass ``own_service=True`` (the CLI does) to have
    :meth:`close` also close the service.
    """

    def __init__(self, service, host: Optional[str] = None,
                 port: Optional[int] = None,
                 unix_path: Optional[str] = None,
                 heartbeat_s: float = 1.0,
                 max_frame: int = MAX_FRAME,
                 own_service: bool = False,
                 auth_token: Optional[str] = None):
        if (unix_path is None) == (port is None):
            raise ValueError("pass exactly one of (host, port) or "
                             "unix_path")
        self.service = service
        self._unix_path = unix_path
        self._host = host or "127.0.0.1"
        self._port = port
        self._heartbeat_s = float(heartbeat_s)
        self._max_frame = int(max_frame)
        self._own_service = bool(own_service)
        self._auth_token = auth_token
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._closing = threading.Event()
        self._closed = threading.Event()
        self.counters = {"connections": 0, "frames_in": 0,
                         "frames_out": 0, "errors": 0,
                         "auth_failures": 0, "bytes_in": 0,
                         "bytes_out": 0, "watch_snapshot_bytes": 0,
                         "watch_delta_bytes": 0}

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "SweepServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def address(self) -> str:
        if self._unix_path is not None:
            return self._unix_path
        return f"{self._host}:{self._port}"

    def start(self) -> "SweepServer":
        if self._unix_path is not None:
            try:
                os.unlink(self._unix_path)
            except FileNotFoundError:
                pass
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(self._unix_path)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self._host, self._port))
            self._port = sock.getsockname()[1]
        sock.listen(64)
        self._listener = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="sweep-server-accept")
        self._accept_thread.start()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0) -> None:
        """Graceful shutdown: stop accepting, shed new submits with a
        ``shutting_down`` error, optionally wait for every admitted
        request to finish (``drain``), then close connections and the
        listener.  In-flight requests are never dropped by a planned
        shutdown — only an unplanned kill leaves work behind, and the
        spool recovers that."""
        self._closing.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if drain:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while self.service._queue.depth or self.service._running:
                if deadline is not None \
                        and time.monotonic() >= deadline:
                    break
                time.sleep(0.02)
        self._closed.set()
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(5.0)
        if self._unix_path is not None:
            try:
                os.unlink(self._unix_path)
            except FileNotFoundError:
                pass
        if self._own_service:
            self.service.close()

    # -- connection handling ----------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return      # listener closed
            with self._conn_lock:
                self._conns.add(conn)
                self.counters["connections"] += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="sweep-server-conn").start()

    def _handshake(self, conn: socket.socket) -> bool:
        """Server side of the protocol-2 greeting.  With an auth token
        configured, the connection is dropped unless the peer answers
        the fresh-nonce HMAC challenge — *before* the server parses a
        single byte of JSON from it."""
        nonce = secrets.token_bytes(_NONCE_LEN)
        flags = _FLAG_AUTH if self._auth_token is not None else 0
        conn.sendall(MAGIC + bytes([flags]) + nonce)
        self.counters["bytes_out"] += len(MAGIC) + 1 + _NONCE_LEN
        if not flags:
            return True
        old = conn.gettimeout()
        conn.settimeout(_HANDSHAKE_TIMEOUT_S)
        try:
            mac = _recv_exact(conn, _MAC_LEN)
        except (ConnectionError, OSError):
            self.counters["auth_failures"] += 1
            return False
        finally:
            conn.settimeout(old)
        self.counters["bytes_in"] += _MAC_LEN
        want = hmac.new(self._auth_token.encode("utf-8"), nonce,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(mac, want):
            self.counters["auth_failures"] += 1
            with contextlib.suppress(OSError):
                conn.sendall(b"\x00")
            return False
        conn.sendall(b"\x01")
        self.counters["bytes_out"] += 1
        return True

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()

        def send(payload: dict) -> int:
            data = encode_frame(payload)
            with wlock:
                conn.sendall(data)
            self.counters["frames_out"] += 1
            self.counters["bytes_out"] += len(data)
            return len(data)

        try:
            if not self._handshake(conn):
                return
            while not self._closed.is_set():
                try:
                    msg = read_frame(conn, self._max_frame,
                                     self.counters)
                except (TimeoutError, socket.timeout):
                    continue
                if msg is None:
                    return
                self.counters["frames_in"] += 1
                rid = msg.get("rid")
                try:
                    self._handle(msg, rid, send)
                except (ConnectionError, BrokenPipeError, OSError):
                    raise
                except BackpressureError as e:
                    send({"rid": rid, "error": "backpressure",
                          "message": str(e),
                          "queue_depth": e.queue_depth,
                          "capacity": e.capacity,
                          "retry_after_s": e.retry_after_s,
                          "tenant": e.tenant})
                except Exception as e:
                    self.counters["errors"] += 1
                    send({"rid": rid, "error": _error_kind(e),
                          "message": str(e)})
        except (ConnectionError, BrokenPipeError, OSError):
            pass        # client went away: its tickets stay admitted
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- operations ---------------------------------------------------

    def _handle(self, msg: dict, rid, send) -> None:
        from ..core import service as CS
        op = msg.get("op")
        if op == "ping":
            send({"rid": rid, "pong": True, "protocol": PROTOCOL,
                  "alive": not self._closing.is_set()})
            return
        if op == "health":
            send({"rid": rid,
                  "health": {**self.service.health(),
                             "transport": dict(self.counters)}})
            return
        if op == "submit":
            if self._closing.is_set():
                send({"rid": rid, "error": "shutting_down",
                      "message": "server is draining for shutdown — "
                                 "retry against the restarted server",
                      "retry_after_s": 1.0})
                return
            req = CS.SweepRequest.from_json(msg["request"])
            before = self.service.counters["deduped"]
            t = self.service.submit(req,
                                    client_id=msg.get("client_id"))
            send({"rid": rid, "id": t.id, "state": t.state,
                  "deduped": self.service.counters["deduped"] > before})
            return
        if op in ("status", "result", "watch", "cancel"):
            t = self.service.get(msg.get("id", ""))
            if t is None:
                send({"rid": rid, "error": "not_found",
                      "message": f"unknown request id "
                                 f"{msg.get('id')!r}"})
                return
            if op == "status":
                send({"rid": rid, **t.summary()})
                return
            if op == "cancel":
                t.cancel()
                send({"rid": rid, "id": t.id, "state": t.state,
                      "cancelled": True})
                return
            if op == "result":
                self._stream_until_done(t, rid, send,
                                        msg.get("timeout"),
                                        watch=False, last_seq=0)
                return
            self._stream_until_done(t, rid, send, msg.get("timeout"),
                                    watch=True,
                                    last_seq=int(msg.get("last_seq",
                                                         0)))
            return
        send({"rid": rid, "error": "bad_request",
              "message": f"unknown op {op!r}"})

    def _stream_until_done(self, t, rid, send, timeout, watch: bool,
                           last_seq: int) -> None:
        """Block on one ticket, emitting heartbeat (and, for ``watch``,
        progress-snapshot) frames until it finishes, then the final
        result frame.  Runs on the connection's reader thread."""
        from ..core import stream as ST
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        prev_snap = None
        while not t.done():
            if deadline is not None and time.monotonic() >= deadline:
                send({"rid": rid, "error": "timeout",
                      "message": f"request {t.id} not finished within "
                                 f"{timeout}s", **t.summary()})
                return
            if self._closed.is_set():
                send({"rid": rid, "error": "closed",
                      "message": "server closed while waiting"})
                return
            seq, snap = t.wait_snapshot(last_seq,
                                        timeout=self._heartbeat_s)
            if watch and seq > last_seq and snap is not None:
                last_seq = seq
                # "snapshot", not "progress": ticket summaries carry a
                # float "progress" field, and the final frame embeds a
                # summary — the streaming key must never collide with
                # it or clients would skip the final frame.
                if prev_snap is None:
                    # Full baseline first (also after a reconnecting
                    # watch — the server cannot know what the client
                    # still holds), per-chunk deltas from then on.
                    n = send({"rid": rid, "snapshot": snap,
                              "seq": seq})
                    self.counters["watch_snapshot_bytes"] += n
                else:
                    n = send({"rid": rid, "seq": seq,
                              "delta": ST.result_delta_to_json(
                                  prev_snap, snap)})
                    self.counters["watch_delta_bytes"] += n
                prev_snap = snap
            elif not t.done():
                send({"rid": rid, "hb": True, **t.summary()})
        out = {"rid": rid, "done": True, **t.summary()}
        if t._error is not None and t._result is None:
            kind = _error_kind(t._error)
            send({**out, "error": kind, "message": str(t._error)})
            return
        out["result"] = ST.result_to_json(t._result)
        send(out)


def _error_kind(e: BaseException) -> str:
    from ..core import service as CS
    if isinstance(e, BackpressureError):
        return "backpressure"
    if isinstance(e, CS.CancelledError):
        return "cancelled"
    if isinstance(e, CS.ServiceClosedError):
        return "closed"
    if isinstance(e, (ValueError, KeyError, TypeError)):
        return "bad_request"
    return "internal"
