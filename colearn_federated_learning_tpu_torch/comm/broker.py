"""Tiny TCP pub/sub broker, the control plane's MQTT stand-in (the
counterpart of the JAX package's ``comm/broker.py``, speaking the same
frames, so either package's clients use either package's broker):

- ``{"op": "sub", "topic": t}``: subscribe this connection to ``t``; a
  trailing ``#`` subscribes to the whole prefix;
- ``{"op": "pub", "topic": t, ...}`` + body: fan out to every subscriber,
  extra header fields and body verbatim;
- ``"retain": true`` on a publish keeps the topic's last message and
  replays it to later subscribers (role assignments and enrollments).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Optional

from colearn_federated_learning_tpu_torch.comm import protocol


def _match(pattern: str, topic: str) -> bool:
    if pattern.endswith("#"):
        return topic.startswith(pattern[:-1])
    return pattern == topic


class MessageBroker:
    """Threaded pub/sub broker.  ``port=0`` picks a free port (read it back
    from ``.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.host, self.port = self._srv.getsockname()
        self._lock = threading.Lock()
        self._subs: dict[socket.socket, list[str]] = {}
        # Per-socket write locks: publishers fan out concurrently and
        # frames must never interleave on a subscriber's stream.
        self._wlocks: dict[socket.socket, threading.Lock] = {}
        self._retained: dict[str, tuple[dict, bytes]] = {}
        self._stopping = threading.Event()

    def start(self) -> "MessageBroker":
        threading.Thread(target=self._accept_loop, name="broker-accept",
                         daemon=True).start()
        return self

    def stop(self, wake_timeout: float = 1.0) -> None:
        self._stopping.set()
        protocol.wake_accept(self.host, self.port, timeout=wake_timeout)
        protocol.close_quietly(self._srv)
        with self._lock:
            # Every accepted connection, subscribed or not.
            socks = set(self._subs) | set(self._wlocks)
            self._subs.clear()
            self._wlocks.clear()
        for s in socks:
            # shutdown first: close alone does not end a blocked recv, so
            # no FIN would reach the peer.
            protocol.close_quietly(s, shutdown=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._srv.accept()   # stop() wakes it
            except OSError:
                return
            if self._stopping.is_set():
                protocol.close_quietly(conn)
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._wlocks[conn] = threading.Lock()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="broker-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                header, body = protocol.recv_msg(conn)
                op = header.get("op")
                if op == "sub":
                    self._subscribe(conn, header["topic"],
                                    ack=bool(header.get("ack")))
                elif op == "pub":
                    self._publish(header, body)
                elif op == "ping":
                    self._send(conn, {"op": "pong"}, b"")
        except protocol.ConnectionClosed:
            pass                       # the client left
        except (OSError, ValueError):
            protocol.count_suppressed()   # a flaky or buggy peer: drop it
        finally:
            with self._lock:
                self._subs.pop(conn, None)
                self._wlocks.pop(conn, None)
            protocol.close_quietly(conn)

    def _send(self, conn: socket.socket, header: dict, body: bytes) -> None:
        with self._lock:
            wlock = self._wlocks.get(conn)
        if wlock is None:
            return
        try:
            with wlock:
                protocol.send_msg(conn, header, body)
        except OSError:
            # A dead subscriber must not break the fan-out; its serve
            # thread reaps it.
            protocol.count_suppressed()

    def _subscribe(self, conn: socket.socket, pattern: str,
                   ack: bool = False) -> None:
        """Register ``pattern`` (idempotent; a re-subscribe replays the
        retained messages) and, with ``ack``, follow the replay with a
        ``suback`` frame so the client knows the replay is complete."""
        with self._lock:
            pats = self._subs.setdefault(conn, [])
            if pattern not in pats:
                pats.append(pattern)
            replay = [(dict(h), b) for t, (h, b) in self._retained.items()
                      if _match(pattern, t)]
        for h, b in replay:
            self._send(conn, h, b)
        if ack:
            self._send(conn, {"op": "suback", "topic": pattern}, b"")

    def _publish(self, header: dict, body: bytes) -> None:
        topic = header["topic"]
        out = {k: v for k, v in header.items() if k not in ("op", "retain")}
        out["op"] = "msg"
        with self._lock:
            if header.get("retain"):
                self._retained[topic] = (out, body)
            targets = [s for s, pats in self._subs.items()
                       if any(_match(p, topic) for p in pats)]
        for s in targets:
            self._send(s, out, body)


class BrokerClient:
    """One connection to the broker: publish anywhere, receive subscribed
    messages with ``recv(timeout=...)``.  A reader thread drains frames
    into a queue, so a consumer's timeout never strands the socket
    mid-frame."""

    def __init__(self, host: str, port: int, timeout: Optional[float] = None):
        self._sock = protocol.connect(host, port, timeout=timeout)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._dead = threading.Event()
        self._q: "queue.Queue[Optional[tuple[dict, bytes]]]" = queue.Queue()
        threading.Thread(target=self._read_loop, name="broker-client-read",
                         daemon=True).start()

    def _read_loop(self) -> None:
        try:
            while True:
                self._q.put(protocol.recv_msg(self._sock))
        except (protocol.ConnectionClosed, OSError, ValueError):
            self._dead.set()
            self._q.put(None)                 # the connection is gone

    def alive(self) -> bool:
        """False once the broker connection died; messages received before
        are still drainable."""
        return not self._dead.is_set()

    def subscribe(self, topic: str, ack: bool = False) -> None:
        header = {"op": "sub", "topic": topic}
        if ack:
            header["ack"] = True
        with self._wlock:
            protocol.send_msg(self._sock, header)

    def publish(self, topic: str, fields: Optional[dict] = None,
                body: bytes = b"", retain: bool = False) -> None:
        header = {"op": "pub", "topic": topic, **(fields or {})}
        if retain:
            header["retain"] = True
        with self._wlock:
            protocol.send_msg(self._sock, header, body)

    def recv(self, timeout: Optional[float] = None) -> tuple[dict, bytes]:
        """Next message on any subscribed topic: ``TimeoutError`` after
        ``timeout`` seconds, ``ConnectionClosed`` on a dead broker."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("no broker message") from None
        if item is None:
            raise protocol.ConnectionClosed("broker connection closed")
        return item

    def close(self) -> None:
        protocol.close_quietly(self._sock)
