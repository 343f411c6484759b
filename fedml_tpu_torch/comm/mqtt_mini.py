"""Minimal MQTT 3.1.1 client + in-process broker (stdlib sockets only).

The reference's third transport is MQTT via paho + an external broker
(fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py). This image
bundles neither paho nor a broker binary, so the backend would be dead code
here; this module implements the small slice of MQTT 3.1.1 the FL managers
need — CONNECT/CONNACK, SUBSCRIBE/SUBACK (exact-match topics), PUBLISH QoS
0/1 with PUBACK, PINGREQ/PINGRESP, DISCONNECT — as a paho fallback, plus a
loopback broker so the pub/sub path is actually testable end-to-end.

Scope notes (deliberate): no wildcard topics (the fedml topic scheme uses
exact names), no QoS 2, no persistent sessions, no QoS-1 redelivery (TCP
ordering + the managers' idempotent handlers make at-most-once-per-
connection sufficient for tests; production deployments point the same
manager at a real broker via paho). Retained messages ARE implemented:
pub/sub has an inherent startup race (a publish to a topic nobody has
subscribed to yet is dropped), and parties boot in arbitrary order — the
server's init message is published with RETAIN so a later-subscribing
client still receives it.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading

log = logging.getLogger("fedml_tpu_torch.comm.mqtt_mini")

CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, PINGREQ, PINGRESP, DISCONNECT = 8, 9, 12, 13, 14


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mqtt: peer closed")
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> tuple[int, int, bytes]:
    """-> (type, flags, body). Blocks; raises ConnectionError on EOF."""
    h = _read_exact(sock, 1)[0]
    length, mult = 0, 1
    while True:
        b = _read_exact(sock, 1)[0]
        length += (b & 0x7F) * mult
        if not (b & 0x80):
            break
        mult *= 128
        if mult > 128**3:
            raise ValueError("mqtt: malformed varint")
    return h >> 4, h & 0x0F, _read_exact(sock, length) if length else b""


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _encode_varint(len(body)) + body


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def retry_connect(connect, desc: str, deadline_s: float = 120.0):
    """Run ``connect()`` until it succeeds or ``deadline_s`` passes. Peers
    boot in arbitrary order — a rank that comes up before the broker (e.g.
    rank 0 hosting it via --serve_broker) must wait, not die on
    ConnectionRefused (the transport-level analogue of the gRPC backend's
    wait_for_ready). Shared by the mini client and the paho path; warnings
    are throttled to one per ~10 attempts."""
    import time

    deadline = time.monotonic() + deadline_s
    attempt = 0
    while True:
        try:
            return connect()
        except OSError as e:
            attempt += 1
            if time.monotonic() >= deadline:
                raise ConnectionError(
                    f"mqtt: {desc} unreachable for {deadline_s:.0f}s: {e}"
                ) from e
            if attempt % 10 == 1:
                log.warning("mqtt: %s not up yet, retrying", desc)
            time.sleep(1.0)


class MiniMqttClient:
    """Tiny synchronous-publish / threaded-receive MQTT 3.1.1 client."""

    def __init__(self, host: str, port: int, client_id: str,
                 on_message=None, keepalive: int = 0):
        # keepalive=0 disables the broker's inactivity timeout (MQTT 3.1.1
        # §3.1.2.10) — this client sends no PINGREQs, and FL rounds can be
        # minutes of silence between messages
        self.on_message = on_message
        self._sock = self._connect_with_retry(host, port)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._pid = 0
        body = (_mqtt_str("MQTT") + bytes([4]) + bytes([0x02])
                + struct.pack(">H", keepalive) + _mqtt_str(client_id))
        self._send(_packet(CONNECT, 0, body))
        t, _, b = _read_packet(self._sock)
        if t != CONNACK or (len(b) >= 2 and b[1] != 0):
            raise ConnectionError(f"mqtt: connect refused ({b!r})")
        self._alive = True
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    @staticmethod
    def _connect_with_retry(host: str, port: int,
                            deadline_s: float = 120.0) -> socket.socket:
        return retry_connect(
            lambda: socket.create_connection((host, port), timeout=30),
            f"broker {host}:{port}", deadline_s)

    def _send(self, data: bytes) -> None:
        with self._wlock:
            self._sock.sendall(data)

    def _next_pid(self) -> int:
        self._pid = self._pid % 65535 + 1
        return self._pid

    def subscribe(self, topic: str, qos: int = 1) -> None:
        body = struct.pack(">H", self._next_pid()) + _mqtt_str(topic) + bytes([qos])
        self._send(_packet(SUBSCRIBE, 0x02, body))
        # SUBACK is consumed by the reader thread (no granted-qos check —
        # the broker below always grants)

    def publish(self, topic: str, payload: bytes, qos: int = 1,
                retain: bool = False) -> None:
        r = 0x01 if retain else 0x00
        if qos == 0:
            self._send(_packet(PUBLISH, r, _mqtt_str(topic) + payload))
            return
        body = _mqtt_str(topic) + struct.pack(">H", self._next_pid()) + payload
        self._send(_packet(PUBLISH, 0x02 | r, body))  # QoS1; PUBACK via reader

    def _reader(self) -> None:
        try:
            while self._alive:
                t, flags, body = _read_packet(self._sock)
                if t == PUBLISH:
                    tl = struct.unpack(">H", body[:2])[0]
                    topic = body[2 : 2 + tl].decode()
                    rest = body[2 + tl :]
                    qos = (flags >> 1) & 0x03
                    if qos:
                        pid, rest = struct.unpack(">H", rest[:2])[0], rest[2:]
                        self._send(_packet(PUBACK, 0, struct.pack(">H", pid)))
                    if self.on_message is not None:
                        self.on_message(topic, rest)
                elif t == PINGREQ:
                    self._send(_packet(PINGRESP, 0, b""))
                # SUBACK / PUBACK / PINGRESP: no client-side state to update
        except (ConnectionError, OSError) as e:
            if self._alive:  # unexpected death, not close(): say so
                log.error("mqtt: connection to broker lost: %s", e)

    def close(self) -> None:
        """DISCONNECT, half-close, drain, close. A socket closed with
        unread bytes in its receive buffer (the broker's PUBACKs for the
        last QoS-1 publishes) sends a TCP reset, and the reset makes the
        broker's kernel discard the PUBLISH frames it has not read yet: a
        burst published just before close() lost its tail. Shutting the
        write side down instead lets the broker read every frame up to the
        DISCONNECT and close its end; this side reads to that EOF (or for
        2 s at most) before closing, so nothing is left unread."""
        import time

        drain_s = 2.0
        self._alive = False
        try:
            self._send(_packet(DISCONNECT, 0, b""))
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        deadline = time.monotonic() + drain_s
        if threading.current_thread() is not self._thread:
            # the reader keeps reading until the broker's EOF
            self._thread.join(timeout=drain_s)
        if not self._thread.is_alive() or \
                threading.current_thread() is self._thread:
            try:
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._sock.settimeout(left)
                    if not self._sock.recv(65536):
                        break
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass


class MiniMqttBroker:
    """Exact-topic-match loopback broker for tests and single-host runs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._subs: dict[str, set[socket.socket]] = {}
        self._retained: dict[str, bytes] = {}  # topic -> last retained payload
        self._socks: list[socket.socket] = []
        self._lock = threading.Lock()
        # one writer a socket: fan-outs from several publishers' threads
        # reach one subscriber's socket at once (see _send)
        self._wlocks: dict[socket.socket, threading.Lock] = {}
        self._alive = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while self._alive:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._socks.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _send(self, sock: socket.socket, data: bytes) -> None:
        """Write one whole packet to ``sock``, one writer at a time. Each
        publisher's connection has its own thread, and two of them fanning
        out to the same subscriber at once interleaved their ``sendall``
        chunks once a packet outgrew the socket buffer (two clients'
        model uploads to the server): the subscriber read a garbled
        stream and waited on a bogus length for good."""
        with self._lock:
            wlock = self._wlocks.setdefault(sock, threading.Lock())
        try:
            with wlock:
                sock.sendall(data)
        except OSError:
            self._drop(sock)

    def _drop(self, sock: socket.socket) -> None:
        with self._lock:
            for subs in self._subs.values():
                subs.discard(sock)
            if sock in self._socks:
                self._socks.remove(sock)
            self._wlocks.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass

    def _serve(self, sock: socket.socket) -> None:
        try:
            t, _, _ = _read_packet(sock)
            if t != CONNECT:
                return
            self._send(sock, _packet(CONNACK, 0, b"\x00\x00"))
            while self._alive:
                t, flags, body = _read_packet(sock)
                if t == SUBSCRIBE:
                    pid = struct.unpack(">H", body[:2])[0]
                    i, grants, retained = 2, [], []
                    while i < len(body):
                        tl = struct.unpack(">H", body[i : i + 2])[0]
                        topic = body[i + 2 : i + 2 + tl].decode()
                        grants.append(body[i + 2 + tl])
                        i += 3 + tl
                        # register + snapshot retained in ONE locked section:
                        # a publisher's (store retained, read subscribers) is
                        # also one section, so exactly one of live fan-out or
                        # retained delivery wins — never both (no dup init)
                        with self._lock:
                            self._subs.setdefault(topic, set()).add(sock)
                            payload = self._retained.get(topic)
                        if payload is not None:
                            retained.append((topic, payload))
                    self._send(sock, _packet(
                        SUBACK, 0, struct.pack(">H", pid) + bytes(grants)))
                    for topic, payload in retained:  # after SUBACK, flag set
                        self._send(sock, _packet(
                            PUBLISH, 0x01, _mqtt_str(topic) + payload))
                elif t == PUBLISH:
                    tl = struct.unpack(">H", body[:2])[0]
                    topic = body[2 : 2 + tl].decode()
                    rest = body[2 + tl :]
                    qos = (flags >> 1) & 0x03
                    if qos:
                        pid, rest = struct.unpack(">H", rest[:2])[0], rest[2:]
                        self._send(sock, _packet(PUBACK, 0, struct.pack(">H", pid)))
                    # store retained + snapshot subscribers in ONE locked
                    # section (see the SUBSCRIBE handler's dual invariant)
                    with self._lock:
                        if flags & 0x01:  # RETAIN: keep for late subscribers
                            if rest:
                                self._retained[topic] = rest
                            else:  # empty retained payload clears (spec 3.3.1.3)
                                self._retained.pop(topic, None)
                        targets = list(self._subs.get(topic, ()))
                    # deliver as QoS0 (subscriber PUBACK bookkeeping not needed)
                    out = _packet(PUBLISH, 0, _mqtt_str(topic) + rest)
                    for s in targets:  # includes the publisher if self-subscribed
                        self._send(s, out)
                elif t == PINGREQ:
                    self._send(sock, _packet(PINGRESP, 0, b""))
                elif t == DISCONNECT:
                    break
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._drop(sock)

    def close(self) -> None:
        self._alive = False
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            socks = list(self._socks)
        for s in socks:
            self._drop(s)
