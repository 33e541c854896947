"""Wire framing: [4B header-len][JSON header][8B body-len][4B crc32][body].

The counterpart of the JAX package's ``comm/protocol.py``, byte for byte:
the same header and body give the same frame, so a process of the port
and one of the JAX package talk to each other.  One frame carries a JSON
control header (message type, topic, round index, ...) and an optional
opaque body (a ``utils/serialization.py`` CLW1 frame).  The pub/sub broker
(control plane) and the tensor transport (data plane) both use it.

Every frame carries a CRC32 over header and body, so a corrupted frame is
a :class:`CorruptFrame` at the receiver: that one peer's failure, never
garbage folded into an aggregate.

Requests carry the sender's span context (``attach_trace``), and a
reply's worker spans are adopted into the receiver's trace
(``pop_trace_spans``).  Every frame counts in ``comm.messages_sent`` /
``comm.messages_received`` and ``comm.bytes_sent`` / ``comm.bytes_received``,
a corrupt one in ``comm.corrupt_frames_total``, and a teardown error that
is survived in ``comm.suppressed_oserrors_total``, as in JAX.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics

_HDR = struct.Struct(">I")     # header length
_BODY = struct.Struct(">QI")   # body length, crc32(header bytes + body)
MAX_HEADER = 1 << 20           # 1 MiB of JSON is already absurd
MAX_BODY = 1 << 34             # 16 GiB

TRACE_KEY = "trace"            # header slot carrying the trace context
TRACE_SPANS_KEY = "trace_spans"  # reply-meta slot carrying worker spans

# Default budget for control-plane connection establishment: generous
# against slow brokers, finite against dead ones.
CONNECT_TIMEOUT = 10.0


def attach_trace(header: dict, context) -> dict:
    """Put a span context ``(trace_id, span_id)`` into ``header`` (in
    place); ``None`` leaves it untouched."""
    if context is not None:
        header[TRACE_KEY] = {"trace_id": context[0], "span_id": context[1]}
    return header


def extract_trace(header: dict):
    """The span context of :func:`attach_trace`, or None for a missing or
    malformed one."""
    ctx = header.get(TRACE_KEY)
    if not isinstance(ctx, dict):
        return None
    trace_id, span_id = ctx.get("trace_id"), ctx.get("span_id")
    if not (isinstance(trace_id, str) and isinstance(span_id, str)):
        return None
    return (trace_id, span_id)


def pop_trace_spans(meta, tracer) -> None:
    """Stitch a reply's worker-side spans into ``tracer`` and strip them
    from the metadata, so they never leak into round records."""
    if not isinstance(meta, dict):
        return
    spans = meta.pop(TRACE_SPANS_KEY, None)
    if spans:
        tracer.adopt(spans)


class ConnectionClosed(Exception):
    """Peer closed the socket mid-frame (or before one started)."""


class CorruptFrame(ValueError):
    """Frame failed an integrity check (length sanity or CRC32 mismatch).
    A ``ValueError``, so every per-connection handler treats it as that
    peer's failure; the stream is unrecoverable past it."""


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, read into one preallocated buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)  # colearn: noqa(CL002): deadline is the caller's settimeout
        if not r:
            raise ConnectionClosed(f"peer closed after {got}/{n} bytes")
        got += r
    return buf


def _corrupt(msg: str) -> CorruptFrame:
    _metrics.get_registry().counter("comm.corrupt_frames_total").inc()
    return CorruptFrame(f"corrupt frame: {msg}")


def frame_crc(hdr: bytes, body: bytes) -> int:
    return zlib.crc32(body, zlib.crc32(hdr))


def send_msg(sock: socket.socket, header: dict, body=b"") -> None:
    """``body`` is any bytes-like object; a shared broadcast frame is sent
    without a copy."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    if len(hdr) > MAX_HEADER:
        raise ValueError(f"header too large: {len(hdr)}")
    prefix = (_HDR.pack(len(hdr)) + hdr
              + _BODY.pack(len(body), frame_crc(hdr, body)))
    if body:
        # One vectored syscall for prefix and body; finish a partial send
        # with sendall on views.
        sent = sock.sendmsg([prefix, body])
        if sent < len(prefix) + len(body):
            if sent < len(prefix):
                sock.sendall(memoryview(prefix)[sent:])
                sock.sendall(body)
            else:
                sock.sendall(memoryview(body)[sent - len(prefix):])
    else:
        sock.sendall(prefix)
    reg = _metrics.get_registry()
    reg.counter("comm.messages_sent").inc()
    reg.counter("comm.bytes_sent").inc(
        _HDR.size + len(hdr) + _BODY.size + len(body))


def recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    (hlen,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if hlen > MAX_HEADER:
        raise _corrupt(f"header length {hlen}")
    hdr = _recv_exact(sock, hlen)
    (blen, crc) = _BODY.unpack(_recv_exact(sock, _BODY.size))
    if blen > MAX_BODY:
        raise _corrupt(f"body length {blen}")
    body = _recv_exact(sock, blen) if blen else b""
    if frame_crc(hdr, body) != crc:
        raise _corrupt("crc32 mismatch")
    try:
        header = json.loads(hdr.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _corrupt(f"undecodable header ({e})") from None
    reg = _metrics.get_registry()
    reg.counter("comm.messages_received").inc()
    reg.counter("comm.bytes_received").inc(
        _HDR.size + hlen + _BODY.size + blen)
    return header, body


def connect(host: str, port: int,
            timeout: Optional[float] = None) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def count_suppressed(n: int = 1) -> None:
    """Count an error that is survived on purpose (a teardown, a dead
    peer): never silent."""
    _metrics.get_registry().counter("comm.suppressed_oserrors_total").inc(n)


def close_quietly(sock: socket.socket, shutdown: bool = False) -> None:
    """Teardown close; the peer may already be gone (its OSError counts in
    ``comm.suppressed_oserrors_total``).  ``shutdown=True`` shuts the
    stream down first, which (unlike close alone) unblocks a thread
    reading it."""
    if shutdown:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            count_suppressed()
    try:
        sock.close()
    except OSError:
        count_suppressed()


def wake_accept(host: str, port: int, timeout: float = 1.0) -> None:
    """Unblock a thread stuck in ``accept(2)`` on (host, port): closing a
    listening socket from another thread does not interrupt the call on
    Linux, so a throwaway connection does.  Callers set their stop flag
    first."""
    try:
        socket.create_connection((host, port), timeout=timeout).close()
    except OSError:
        count_suppressed()
