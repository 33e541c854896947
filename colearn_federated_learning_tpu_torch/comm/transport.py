"""Tensor plane: request/reply transport between the coordinator and a
device (the counterpart of the JAX package's ``comm/transport.py``).

A device hosts a :class:`TensorServer` whose handler maps ``(header,
tree) -> (header, tree)``; the coordinator's :class:`TensorClient` does
one round trip per request.  Bodies are ``utils/serialization.py`` CLW1
frames, byte-equal to the JAX package's, so either package's client
talks to either package's server.

Two robustness seams, which cost nothing when off:

- an optional process-wide :class:`TransportInterposer`, consulted at each
  request/reply boundary (the fault-injection hook; ``faults/inject.py``);
- ``TensorClient.request`` takes an optional :class:`RetryPolicy` and a
  shared ``deadline``: transient failures (reset connections, corrupt
  frames) are retried on a fresh socket with exponential backoff and full
  jitter, every attempt budgeted against the one deadline.  Timeouts are
  not retried: a peer that used the whole budget is a straggler.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time
import zlib
from typing import Any, Callable, Optional

from colearn_federated_learning_tpu_torch.comm import protocol
from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics
from colearn_federated_learning_tpu_torch.utils.serialization import (
    bytes_to_pytree, pytree_to_bytes)

Handler = Callable[[dict, Any], tuple[dict, Any]]


class SkipRequest(Exception):
    """Raised by an interposer to make the server discard the current
    request: no reply, connection kept.  The client times out, as after a
    lost datagram."""


class TransportInterposer:
    """Hook points the transport consults when one is installed; the base
    class does nothing.  Hooks act through ordinary transport exceptions
    or by writing to or closing the socket themselves."""

    def server_request(self, server: "TensorServer", conn: socket.socket,
                       header: dict) -> None:
        """After a request frame is received, before the handler runs."""

    def server_reply(self, server: "TensorServer", conn: socket.socket,
                     header: dict) -> None:
        """Before the reply frame is sent; ``header`` is the request's."""

    def client_request(self, client: "TensorClient", header: dict) -> None:
        """Before the client sends a request frame."""


_interposer: Optional[TransportInterposer] = None


def install_interposer(obj: Optional[TransportInterposer]) -> None:
    """Install (or with ``None`` remove) the process-wide interposer."""
    global _interposer
    _interposer = obj


def current_interposer() -> Optional[TransportInterposer]:
    return _interposer


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and full jitter: sleep
    ~ U(0, min(max, base · 2^attempt)).  ``max_retries`` counts re-tries;
    0 disables retrying."""

    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_max: float = 2.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        cap = min(self.backoff_max, self.backoff_base * (2.0 ** attempt))
        return rng.uniform(0.0, cap)


class TensorServer:
    """Serve ``handler`` on a TCP port (``port=0``: an ephemeral one, see
    ``.port``), one thread per connection; a connection may carry many
    requests.  ``ident`` names the hosted device, which keys an
    interposer's faults."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0, ident: str = ""):
        self._handler = handler
        self.ident = ident
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stopping = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()

    def start(self) -> "TensorServer":
        threading.Thread(target=self._accept_loop, name="tensor-accept",
                         daemon=True).start()
        return self

    def stop(self, wake_timeout: float = 1.0) -> None:
        """Stop accepting and sever live connections."""
        self._stopping.set()
        protocol.wake_accept(self.host, self.port, timeout=wake_timeout)
        protocol.close_quietly(self._srv)
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            protocol.close_quietly(c, shutdown=True)

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
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="tensor-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                header, body = protocol.recv_msg(conn)
                ip = _interposer
                try:
                    if ip is not None:
                        ip.server_request(self, conn, header)
                except SkipRequest:
                    continue           # the request is lost by design
                tree, meta = bytes_to_pytree(body) if body else (None, {})
                header.setdefault("meta", meta)
                try:
                    out_header, out_tree = self._handler(header, tree)
                except Exception as e:  # report, keep serving
                    out_header, out_tree = {"status": "error",
                                            "error": repr(e)}, None
                out_body = (
                    pytree_to_bytes(out_tree, out_header.pop("meta", None))
                    if out_tree is not None else b"")
                out_header.setdefault("status", "ok")
                if ip is not None:
                    ip.server_reply(self, conn, header)
                protocol.send_msg(conn, out_header, out_body)
        except protocol.ConnectionClosed:
            pass                       # the peer left
        except (OSError, ValueError):
            protocol.count_suppressed()   # a flaky or buggy peer: drop it
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            protocol.close_quietly(conn)


# Failures a retry can fix: the exchange died, the peer may be alive.
# TimeoutError (an OSError) is re-raised before this is consulted.
_RETRYABLE = (protocol.ConnectionClosed, protocol.CorruptFrame, OSError)


class TensorClient:
    """The coordinator's connection to one device's server.  ``ident``
    names the peer; it keys interposer faults and seeds this client's
    retry jitter."""

    def __init__(self, host: str, port: int, timeout: Optional[float] = None,
                 ident: str = ""):
        self._host, self._port = host, port
        self.ident = ident or f"{host}:{port}"
        self._rng = random.Random(zlib.crc32(self.ident.encode()))
        self.closed = False
        # Backoff waits on this, so close() wakes a retrier at once.
        self._closing = threading.Event()
        self._sock = protocol.connect(host, port, timeout=timeout)

    def _reconnect(self, timeout: Optional[float]) -> None:
        protocol.close_quietly(self._sock)
        if self.closed:
            # An abandoned ask must not resurrect a connection its owner
            # already replaced.
            raise protocol.ConnectionClosed(f"{self.ident}: client closed")
        self._sock = protocol.connect(self._host, self._port, timeout=timeout)

    def request(self, header: dict, tree: Any = None,
                meta: Optional[dict] = None,
                timeout: Optional[float] = None,
                retry: Optional[RetryPolicy] = None,
                deadline: Optional[float] = None,
                body: Any = None) -> tuple[dict, Any]:
        """One round trip; raises ``TimeoutError``/``OSError`` on a dead or
        too slow peer.

        ``body`` is an optional pre-encoded CLW1 frame shared read-only
        across calls (the serialize-once broadcast), exclusive of
        ``tree``/``meta``.  With ``retry``, transient failures are retried
        on a fresh socket; ``deadline`` (a ``time.monotonic()`` instant)
        bounds every attempt and backoff sleep together."""
        if body is None:
            body = pytree_to_bytes(tree, meta) if tree is not None else b""
        elif tree is not None:
            raise ValueError("pass either a pre-encoded body or a tree, "
                             "not both")
        if self.closed:
            raise protocol.ConnectionClosed(f"{self.ident}: client closed")
        attempts = 1 + (retry.max_retries if retry is not None else 0)
        # Labelled per peer: the aggregate counts every retry, and the
        # {device=...} children say who is flaky.
        peer_retries = _metrics.get_registry().counter(
            "comm.retry_total", labels={"device": self.ident})
        for attempt in range(attempts):
            attempt_timeout = timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self.ident}: round deadline exhausted before "
                        f"attempt {attempt + 1}")
                attempt_timeout = (remaining if attempt_timeout is None
                                   else min(attempt_timeout, remaining))
            try:
                ip = _interposer
                if ip is not None:
                    ip.client_request(self, header)
                self._sock.settimeout(attempt_timeout)
                protocol.send_msg(self._sock, header, body)
                out_header, out_body = protocol.recv_msg(self._sock)
                break
            except TimeoutError:
                raise                    # straggler: retrying cannot help
            except _RETRYABLE:
                if attempt + 1 >= attempts:
                    raise
                peer_retries.inc()
                delay = retry.delay(attempt, self._rng)
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - time.monotonic()))
                if delay > 0 and self._closing.wait(delay):
                    raise protocol.ConnectionClosed(
                        f"{self.ident}: client closed during retry backoff")
                # A failed reconnect is the next attempt's failure.
                try:
                    self._reconnect(attempt_timeout)
                except TimeoutError:
                    raise
                except _RETRYABLE:
                    if attempt + 2 >= attempts:
                        raise
        out_tree, out_meta = (bytes_to_pytree(out_body) if out_body
                              else (None, {}))
        out_header.setdefault("meta", out_meta)
        return out_header, out_tree

    def close(self) -> None:
        # Flag before closing: a concurrent abandoned request sees it and
        # aborts instead of retrying onto a fresh connection.
        self.closed = True
        self._closing.set()
        protocol.close_quietly(self._sock)
