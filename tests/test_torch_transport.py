"""The port's networked sweep service on the CPU: framing, reconnect,
idempotency, streaming, authentication, hedging — the reference's
``tests/test_transport.py`` case for case on
``repro_torch.runtime.transport`` and ``repro_torch.core.client``
(services on ``device="cpu"``; the server child ``python -m
repro_torch.service --device cpu``), and the networked result held to
the reference's served one.

The wire path must add no semantics on top of the in-process service: a
networked result decodes bitwise equal to a solo ``stream_grid`` run of
the port, a retried submit after a dropped connection (or a server
SIGKILL + restart over the same spool) attaches to the existing ticket
instead of executing twice, and overload rejections carry the
``BackpressureError`` fields the in-process API raises.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _jax_reference import assert_matches_reference, deliverables, run
from repro_torch.core import stream
from repro_torch.core.client import (AuthenticationError, RemoteError,
                                     SweepClient)
from repro_torch.core.service import SweepRequest, SweepService
from repro_torch.runtime import BackpressureError, SweepServer
from repro_torch.runtime import transport

# The reference test's grid: two chunks of 97 over 192 configs: enough steps that the progress
# stream emits at least one consistent prefix snapshot before the
# final frame.
GRID = dict(
    agg_nodes=("7nm", "16nm"),
    sensor_nodes=("7nm", "16nm"),
    detnet_fps=tuple(float(f) for f in range(5, 65, 5)),
    keynet_fps=(30.0, 45.0),
    num_cameras=(2.0, 4.0),
)
CHUNK = 97
TOP_K = 4


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


def _assert_bitwise(res, want):
    assert deliverables(res) == deliverables(want)


# ---------------------------------------------------------------------------
# Framing and addressing (no server)
# ---------------------------------------------------------------------------


class TestFraming:
    def _pair(self):
        return socket.socketpair()

    def test_round_trip_including_non_finite(self):
        a, b = self._pair()
        try:
            msg = {"op": "x", "v": [1.5, float("nan"), float("inf")],
                   "s": "naïve"}
            a.sendall(transport.encode_frame(msg))
            out = transport.read_frame(b)
            assert out["op"] == "x" and out["s"] == "naïve"
            assert out["v"][0] == 1.5
            assert np.isnan(out["v"][1]) and np.isinf(out["v"][2])
        finally:
            a.close(), b.close()

    def test_clean_eof_returns_none(self):
        a, b = self._pair()
        a.close()
        try:
            assert transport.read_frame(b) is None
        finally:
            b.close()

    def test_torn_frame_raises_connection_error(self):
        a, b = self._pair()
        try:
            frame = transport.encode_frame({"op": "x"})
            a.sendall(frame[: len(frame) - 2])
            a.close()
            with pytest.raises(ConnectionError):
                transport.read_frame(b)
        finally:
            b.close()

    def test_oversized_announcement_rejected_before_allocation(self):
        a, b = self._pair()
        try:
            a.sendall(transport._LEN.pack(2 ** 31))
            with pytest.raises(ConnectionError, match="cap"):
                transport.read_frame(b, max_frame=1024)
        finally:
            a.close(), b.close()

    def test_encode_rejects_oversized_payload(self):
        with pytest.raises(ValueError, match="exceeds"):
            transport.encode_frame(
                {"blob": "x" * (transport.MAX_FRAME + 1)})

    def test_parse_address(self):
        assert transport.parse_address("127.0.0.1:9000") == \
            ("tcp", "127.0.0.1", 9000)
        assert transport.parse_address(":9000") == \
            ("tcp", "127.0.0.1", 9000)
        assert transport.parse_address("/tmp/x.sock") == \
            ("unix", "/tmp/x.sock", None)
        assert transport.parse_address("./rel.sock") == \
            ("unix", "./rel.sock", None)


# ---------------------------------------------------------------------------
# Live server over a Unix socket (one service per module — compile once)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("net") / "svc.sock")
    svc = _service(capacity=8, snapshot_every_s=0.0)
    svc.set_tenant("capped", weight=1.0, max_pending=1)
    server = SweepServer(svc, unix_path=sock, heartbeat_s=0.1,
                         own_service=True).start()
    yield server
    server.close(drain=False, timeout=10.0)


@pytest.fixture(scope="module")
def solo():
    return stream.stream_grid(**GRID, track="all", chunk_size=CHUNK,
                              top_k=TOP_K, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return run("service", requests={"net": _kw()})


@pytest.fixture()
def client(served):
    with SweepClient(served.address, reconnect_timeout_s=10.0) as cli:
        yield cli


class TestNetworkedService:
    def test_ping_and_health(self, client):
        out = client.ping()
        assert out["pong"] is True
        assert out["protocol"] == transport.PROTOCOL
        assert "counters" in client.health()

    def test_result_is_bitwise_identical_with_snapshots(self, client,
                                                        solo, ref):
        snaps = []
        t = client.submit(_request())
        res = t.result(timeout=600, on_progress=snaps.append)
        _assert_bitwise(res, solo)
        assert_matches_reference(res, ref["served"]["net"])
        assert not res.partial
        assert len(snaps) >= 1
        fracs = [s["fraction_complete"] for s in snaps]
        assert fracs == sorted(fracs)          # consistent prefix only
        assert all(0.0 < f <= 1.0 for f in fracs)
        assert all("best" in s and s["partial"] for s in snaps)

    def test_resubmit_same_client_id_dedupes(self, client):
        t1 = client.submit(_request(), client_id="idem-1")
        t2 = client.submit(_request(), client_id="idem-1")
        assert t1.id == t2.id
        res1 = t1.result(timeout=600)
        res2 = t2.result(timeout=600)
        _assert_bitwise(res1, res2)
        assert client.health()["counters"]["deduped"] >= 1

    def test_same_client_id_different_request_rejected(self, client):
        client.submit(_request(), client_id="idem-2")
        with pytest.raises(ValueError, match="already used"):
            client.submit(_request(top_k=TOP_K + 1),
                          client_id="idem-2")

    def test_unknown_ticket_is_not_found(self, client):
        with pytest.raises(RemoteError) as ei:
            client.status("nope-404")
        assert ei.value.kind == "not_found"

    def test_unknown_op_is_bad_request(self, served):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(served.address)
        try:
            transport.client_handshake(s)  # consume the greeting
            s.sendall(transport.encode_frame({"op": "frobnicate",
                                              "rid": "r1"}))
            out = transport.read_frame(s)
            assert out["error"] == "bad_request"
            assert out["rid"] == "r1"
        finally:
            s.close()

    def test_backpressure_fields_survive_the_wire(self, client,
                                                  served):
        served.service.pause()
        try:
            # tenant "capped" allows one pending request; the second
            # must reject naming the tenant with a retry hint.
            ok = client.submit(_request(tenant="capped"),
                               client_id="bp-1")
            with pytest.raises(BackpressureError) as ei:
                client.submit(_request(tenant="capped",
                                       chunk_size=CHUNK + 3),
                              client_id="bp-2")
            err = ei.value
            assert err.tenant == "capped"
            assert err.queue_depth == 1 and err.capacity == 1
            assert err.retry_after_s is not None
            assert "retry after" in str(err)
            client.cancel(ok.id)
        finally:
            served.service.resume()

    def test_client_reconnects_transparently(self, client):
        assert client.ping()["pong"] is True
        # Sever the connection behind the client's back; the next call
        # must reconnect and succeed without surfacing an error.
        client._sock.shutdown(socket.SHUT_RDWR)
        client._sock.close()
        assert client.ping()["pong"] is True
        assert client.counters["reconnects"] >= 2

    def test_watch_streams_deltas_and_counts_wire_bytes(self, served):
        """After the first full snapshot a watch ships per-chunk
        deltas; the client reassembles full snapshots from them, and
        both sides account the wire bytes."""
        with SweepClient(served.address) as cli:
            snaps = []
            # chunk 31 -> 7 dispatch steps: several progress frames, so
            # at least one must ride the delta encoding.
            t = cli.submit(_request(chunk_size=31))
            res = t.result(timeout=600, on_progress=snaps.append)
            assert not res.partial
            assert len(snaps) >= 2
            for s in snaps:     # every reassembled snap is *full*
                assert {"fraction_complete", "front_size", "partial",
                        "best", "front"} <= set(s)
            fracs = [s["fraction_complete"] for s in snaps]
            assert fracs == sorted(fracs)
            assert res.stats["watch_wire_bytes"] > 0
            tr = cli.health()["transport"]
            assert tr["watch_snapshot_bytes"] > 0
            assert tr["watch_delta_bytes"] > 0
            assert tr["bytes_out"] > tr["bytes_in"] > 0

    def test_watch_timeout_is_a_timeout_not_a_disconnect(self, client,
                                                         served):
        served.service.pause()
        try:
            t = client.submit(_request(chunk_size=CHUNK + 5),
                              client_id="slow-1")
            with pytest.raises(TimeoutError):
                t.result(timeout=0.3)
            # The connection survived: an immediate ping reuses it.
            before = client.counters["reconnects"]
            client.ping()
            assert client.counters["reconnects"] == before
            client.cancel(t.id)
        finally:
            served.service.resume()


# ---------------------------------------------------------------------------
# Chaos: SIGKILL the listening server mid-request (the chaos gate)
# ---------------------------------------------------------------------------


class TestServerKillReconnect:
    """SIGKILL a listening server while a connected client waits on a
    result; a fresh server over the same spool + socket must let the
    client reconnect, dedupe its idempotent resubmit onto the recovered
    ticket, resume from the checkpoint and deliver the bitwise solo
    answer."""

    @staticmethod
    def _start_server(sock_path: str, spool: str):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src")]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.service",
             "--unix", sock_path, "--spool", spool,
             "--checkpoint-every-steps", "1", "--device", "cpu"],
            env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        ready = json.loads(proc.stdout.readline())
        assert ready["listening"] == sock_path, ready
        return proc

    def test_kill_reconnect_dedupe_bitwise(self, tmp_path):
        sock_path = str(tmp_path / "svc.sock")
        spool = str(tmp_path / "spool")
        server_a = self._start_server(sock_path, spool)
        cli = SweepClient(sock_path, reconnect_timeout_s=240.0,
                          heartbeat_grace_s=8.0)
        # A job wide enough that the kill can never race completion:
        # 3840 configs at chunk 31 -> 124 steps, each one checkpointed
        # (fsync'd) before its progress frame goes out, so when the
        # first frame arrives the server still has seconds of work
        # left — even a heavily-loaded host can deliver the SIGKILL
        # mid-execution, and any observed progress is backed by a
        # durable checkpoint to resume from.  The solo reference runs
        # the same chunk size: this grid has near-tied front points
        # whose channel values drift by an ulp across chunk lowerings,
        # so bitwise parity is only defined lowering-for-lowering.
        kill_grid = dict(
            GRID,
            detnet_fps=tuple(float(f) for f in range(5, 65, 1)),
            keynet_fps=(30.0, 37.5, 45.0, 52.5))
        want = stream.stream_grid(**kill_grid, track="all",
                                  chunk_size=31, top_k=TOP_K,
                                  device="cpu")
        ticket = cli.submit(
            _request(grid=kill_grid, chunk_size=31),
            client_id="chaos-1")
        first_id = ticket.id
        seen = {"frac": 0.0}
        box = {}

        def wait_result():
            try:
                box["res"] = ticket.result(
                    timeout=600,
                    on_progress=lambda s: seen.__setitem__(
                        "frac", s["fraction_complete"]))
            except BaseException as e:     # surfaced by the assert
                box["err"] = e

        th = threading.Thread(target=wait_result)
        th.start()
        deadline = time.monotonic() + 300
        while seen["frac"] == 0.0 and th.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert seen["frac"] > 0.0, "no progress before kill"
        server_a.kill()                    # SIGKILL: no drain, no close
        server_a.wait(30)
        server_b = self._start_server(sock_path, spool)
        try:
            th.join(600)
            assert "err" not in box, repr(box.get("err"))
            res = box["res"]
            # Idempotent dedupe: the re-attach resubmit landed on the
            # journal-recovered ticket, not a new execution.
            assert ticket.id == first_id
            assert res.stats["resumed_from_step"] > 0
            _assert_bitwise(res, want)
            assert cli.counters["reconnects"] >= 2
        finally:
            cli.close()
            server_b.send_signal(signal.SIGTERM)
            server_b.wait(60)


# ---------------------------------------------------------------------------
# Shared-secret HMAC handshake
# ---------------------------------------------------------------------------


@pytest.fixture(scope="class")
def auth_served(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("auth") / "svc.sock")
    svc = _service(capacity=4, snapshot_every_s=0.0)
    server = SweepServer(svc, unix_path=sock, heartbeat_s=0.1,
                         own_service=True,
                         auth_token="open-sesame").start()
    yield server
    server.close(drain=False, timeout=10.0)


class TestAuthHandshake:
    def test_right_token_is_accepted(self, auth_served):
        with SweepClient(auth_served.address,
                         auth="open-sesame") as cli:
            assert cli.ping()["pong"] is True

    def test_missing_token_fails_fast_without_retry(self, auth_served):
        # A hopeless credential must not burn the reconnect budget:
        # AuthenticationError is not a ConnectionError.
        with SweepClient(auth_served.address,
                         reconnect_timeout_s=60.0) as cli:
            t0 = time.monotonic()
            with pytest.raises(AuthenticationError,
                               match="auth token"):
                cli.ping()
            assert time.monotonic() - t0 < 5.0

    def test_wrong_token_is_rejected_before_any_json_parse(
            self, auth_served):
        before = auth_served.counters["auth_failures"]
        with SweepClient(auth_served.address, auth="wrong") as cli:
            with pytest.raises(AuthenticationError, match="rejected"):
                cli.ping()
        # The server never read a frame: rejection happened at the
        # 32-byte MAC, and the failure is accounted.
        assert auth_served.counters["auth_failures"] > before

    def test_unauthenticated_frame_never_reaches_the_parser(
            self, auth_served):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(auth_served.address)
        try:
            greeting = transport._recv_exact(
                s, 4 + 1 + transport._NONCE_LEN)
            assert greeting[:4] == transport.MAGIC
            assert greeting[4] & transport._FLAG_AUTH
            # Answer with garbage the length of a MAC, then try to
            # speak the protocol: the server hangs up instead of
            # parsing the frame.
            s.sendall(b"\x00" * transport._MAC_LEN)
            verdict = s.recv(1)
            assert verdict in (b"", b"\x00")
            # EOF, reset, or a pipe broken mid-send — never a reply
            # frame (BrokenPipeError just means the hang-up already
            # reached us before the write).
            try:
                s.sendall(transport.encode_frame({"op": "ping",
                                                  "rid": "r1"}))
                assert transport.read_frame(s) is None
            except ConnectionError:
                pass
        finally:
            s.close()


# ---------------------------------------------------------------------------
# Hedged submit across replicas (idempotent dedup)
# ---------------------------------------------------------------------------


class TestHedgedSubmit:
    def test_hedged_legs_dedupe_onto_one_execution(self, tmp_path,
                                                   solo):
        svc = _service(capacity=8, snapshot_every_s=0.0)
        sa = str(tmp_path / "a.sock")
        sb = str(tmp_path / "b.sock")
        server_a = SweepServer(svc, unix_path=sa,
                               heartbeat_s=0.1).start()
        server_b = SweepServer(svc, unix_path=sb,
                               heartbeat_s=0.1).start()
        try:
            with SweepClient([sa, sb]) as cli:
                t = cli.submit(_request(), client_id="hedge-1",
                               hedge_s=0.0)
                res = t.result(timeout=600)
                _assert_bitwise(res, solo)
                assert cli.counters["hedged_submits"] == 1
            # Both legs raced the same client_id into one service:
            # at most one execution, the loser deduplicated.
            assert svc.counters["executions"] == 1
        finally:
            server_a.close(drain=False, timeout=10.0)
            server_b.close(drain=False, timeout=10.0)
            svc.close()

    def test_hedge_survives_a_dead_replica(self, tmp_path, solo):
        svc = _service(capacity=8, snapshot_every_s=0.0)
        sa = str(tmp_path / "dead.sock")     # never listening
        sb = str(tmp_path / "live.sock")
        server_b = SweepServer(svc, unix_path=sb,
                               heartbeat_s=0.1).start()
        try:
            with SweepClient([sa, sb], connect_timeout_s=1.0,
                             reconnect_timeout_s=6.0,
                             backoff_max_s=0.2) as cli:
                t = cli.submit(_request(), client_id="hedge-2",
                               hedge_s=0.05)
                # The watch also fails over: the client rotates off
                # the dead primary to the live replica.
                res = t.result(timeout=600)
                _assert_bitwise(res, solo)
                assert cli.counters["failovers"] >= 1
            assert svc.counters["executions"] == 1
        finally:
            server_b.close(drain=False, timeout=10.0)
            svc.close()


# ---------------------------------------------------------------------------
# TCP: the transport the card's service listens on
# ---------------------------------------------------------------------------


class TestTcp:
    def test_tcp_server_with_token_serves_bitwise(self, solo):
        svc = _service(capacity=4, snapshot_every_s=0.0)
        server = SweepServer(svc, host="127.0.0.1", port=0,
                             heartbeat_s=0.1, own_service=True,
                             auth_token="tcp-secret").start()
        try:
            assert transport.parse_address(server.address)[0] == "tcp"
            with SweepClient(server.address, auth="tcp-secret") as cli:
                res = cli.submit(_request()).result(timeout=600)
            _assert_bitwise(res, solo)
        finally:
            server.close(drain=False, timeout=10.0)

    def test_cli_listens_on_tcp_and_drains_on_sigterm(self, tmp_path,
                                                      solo):
        """``python -m repro_torch.service --listen 127.0.0.1:0
        --auth-token ... --device cpu``: the ready line names the port,
        a client with the token is served bitwise, one without is
        refused, and SIGTERM drains to exit 0 with a health line."""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src")]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.service",
             "--listen", "127.0.0.1:0", "--auth-token", "tok",
             "--spool", str(tmp_path / "spool"), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        try:
            addr = json.loads(proc.stdout.readline())["listening"]
            assert transport.parse_address(addr)[0] == "tcp"
            with SweepClient(addr, auth="tok") as cli:
                res = cli.submit(_request()).result(timeout=600)
            _assert_bitwise(res, solo)
            with SweepClient(addr, reconnect_timeout_s=5.0) as bad:
                with pytest.raises(AuthenticationError):
                    bad.ping()
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0
            health = json.loads(out.strip().splitlines()[-1])["health"]
            assert health["counters"]["completed"] == 1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
