"""Transport interposer that applies a :class:`~.plan.FaultPlan` (the
counterpart of the JAX package's ``faults/inject.py``).  Each fault kind
is expressed through the transport's generic seams
(``comm/transport.py``), so the transport carries no fault-specific
control flow:

- ``delay``           sleep ``ms`` before the handler runs;
- ``drop_request``    raise ``SkipRequest``: the request is discarded and
                      the client times out (a lost packet);
- ``flap_reconnect``  raise ``ConnectionClosed``: the server severs the
                      connection before replying, and a retrying client
                      reconnects;
- ``corrupt_payload`` write a frame with a wrong CRC32 in place of the
                      reply, then sever: the client's ``recv_msg`` raises
                      ``CorruptFrame``;
- ``crash_worker``    stop the device's whole server: every later request
                      meets a dead peer.

Every fault that fires counts in ``fault.injected_total{device,kind}`` and
``fault.injected.<kind>``, as in JAX.
"""

from __future__ import annotations

import socket
import time

from colearn_federated_learning_tpu_torch.comm import protocol, transport
from colearn_federated_learning_tpu_torch.faults.plan import FaultPlan
from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics

_REQUEST_KINDS = ("delay", "drop_request", "flap_reconnect", "crash_worker")
_REPLY_KINDS = ("corrupt_payload",)

# The installed plan, shared with the file and hierarchical hooks
# (faults/fileplane.py), so one install drives every plane.
_active_plan: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    """The installed plan, or None (every hook is then a no-op)."""
    return _active_plan


def _key(header: dict) -> tuple:
    rnd = header.get("round")
    return (None if rnd is None else int(rnd)), str(header.get("op", ""))


def _count(kind: str, device: str = "") -> None:
    reg = _metrics.get_registry()
    reg.counter("fault.injected_total",
                labels={"device": str(device), "kind": kind}).inc()
    reg.counter(f"fault.injected.{kind}").inc()


def send_corrupt_frame(sock: socket.socket) -> None:
    """Emit a frame whose CRC32 cannot match its contents, with sane
    lengths, so the receiver reads it whole and fails the integrity
    check."""
    hdr = b'{"status":"ok"}'
    body = b"\x00corrupted\x00"
    crc = protocol.frame_crc(hdr, body) ^ 0xDEADBEEF
    sock.sendall(protocol._HDR.pack(len(hdr)) + hdr
                 + protocol._BODY.pack(len(body), crc) + body)


class FaultInjector(transport.TransportInterposer):
    """Apply ``plan`` at the transport seams (see the module docstring)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def _apply(self, fault, server) -> None:
        _count(fault.kind, server.ident if server is not None else "")
        if fault.kind == "delay":
            time.sleep(fault.ms / 1000.0)
        elif fault.kind == "drop_request":
            raise transport.SkipRequest(f"injected drop ({fault})")
        elif fault.kind == "flap_reconnect":
            raise protocol.ConnectionClosed(f"injected flap ({fault})")
        elif fault.kind == "crash_worker":
            if server is not None:
                server.stop()
            raise protocol.ConnectionClosed(f"injected crash ({fault})")

    def server_request(self, server, conn, header) -> None:
        rnd, op = _key(header)
        for f in self.plan.match(server.ident, rnd, op,
                                 kinds=_REQUEST_KINDS, site="server"):
            self._apply(f, server)

    def server_reply(self, server, conn, header) -> None:
        rnd, op = _key(header)
        for f in self.plan.match(server.ident, rnd, op,
                                 kinds=_REPLY_KINDS, site="server"):
            _count(f.kind, server.ident)
            send_corrupt_frame(conn)
            raise protocol.ConnectionClosed(f"injected corruption ({f})")

    def client_request(self, client, header) -> None:
        rnd, op = _key(header)
        for f in self.plan.match(client.ident, rnd, op,
                                 kinds=("delay", "flap_reconnect"),
                                 site="client"):
            _count(f.kind, client.ident)
            if f.kind == "delay":
                time.sleep(f.ms / 1000.0)
            else:
                raise protocol.ConnectionClosed(f"injected flap ({f})")


def install(plan: FaultPlan) -> FaultInjector:
    """Install ``plan`` process-wide on the transport and the file and
    hierarchical hooks; returns the injector (whose ``plan`` keeps the
    firing ledger).  Call :func:`uninstall` when done."""
    global _active_plan
    injector = FaultInjector(plan)
    transport.install_interposer(injector)
    _active_plan = plan
    return injector


def uninstall() -> None:
    global _active_plan
    transport.install_interposer(None)
    _active_plan = None
