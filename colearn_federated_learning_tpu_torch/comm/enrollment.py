"""Device enrollment and trainer/evaluator role selection (the counterpart
of the JAX package's ``comm/enrollment.py``, on the same topics, so
either package's devices enroll with either package's coordinator):

  device  --pub-->  colearn/enroll/{device_id}  {device_id, host, port,
                                                 num_examples, dataset,
                                                 pubkey, mud}
  coord   --pub-->  colearn/role/{device_id}    {role: trainer|evaluator}

Both sides publish retained per-device topics, so ordering never races: a
coordinator that subscribes after devices announced replays their
enrollments, and a device that subscribes after selection replays its
role.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from colearn_federated_learning_tpu_torch.comm import protocol
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient

ENROLL_TOPIC = "colearn/enroll/"      # + device_id (retained)
ROLE_TOPIC = "colearn/role/"          # + device_id (retained)


class EnrollmentTimeout(TimeoutError):
    """No coordinator assigned this device a role within the enrollment
    window (RunConfig.worker_enroll_timeout for the CLI worker).  Distinct
    from a generic TimeoutError so callers can tell "nobody wanted me"
    from a slow peer mid-round."""


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    device_id: str
    host: str
    port: int                         # tensor-plane server (transport.py)
    num_examples: int = 0
    dataset: str = ""
    # Hex-encoded DH public key for wire-plane secure aggregation
    # (comm/keyexchange.py); empty when the worker runs without masking
    # or in shared_seed mode.
    pubkey: str = ""
    # RFC 8520 MUD profile JSON (comm/mud.py) — the CoLearn identity the
    # coordinator's MudPolicy gates enrollment on; empty = no profile.
    mud: str = ""

    def to_fields(self) -> dict:
        return dataclasses.asdict(self)


def announce(client: BrokerClient, info: DeviceInfo) -> None:
    """Device side: publish readiness (retained)."""
    client.publish(ENROLL_TOPIC + info.device_id, info.to_fields(),
                   retain=True)


def _parse_enroll(header: dict) -> DeviceInfo:
    return DeviceInfo(
        device_id=str(header["device_id"]),
        host=str(header["host"]),
        port=int(header["port"]),
        num_examples=int(header.get("num_examples", 0)),
        dataset=str(header.get("dataset", "")),
        pubkey=str(header.get("pubkey", "")),
        mud=str(header.get("mud", "")),
    )


def fetch_device_info(client: BrokerClient, device_id: str,
                      timeout: float = 10.0,
                      cache: Optional[dict] = None) -> DeviceInfo:
    """Read one device's CURRENT retained enrollment record — how a
    worker looks up a PEER's DH public key for wire-plane secure
    aggregation.

    Subscribes with ``ack`` and reads until the broker's ``suback``
    arrives: everything queued BEFORE it (stale leftovers from earlier
    rounds, live re-announce pushes) is parsed but superseded by later
    records, so the returned record is the one the broker retained at
    subscribe time — a peer that re-enrolled with a fresh key can never
    be read one-restart behind.  Every enrollment record seen is stored
    into ``cache`` (a ``{device_id: DeviceInfo}`` dict the caller keeps
    across calls), so records for other subscribed peers are never
    consumed-and-lost.
    """
    if cache is not None and device_id in cache:
        return cache[device_id]
    topic = ENROLL_TOPIC + device_id
    client.subscribe(topic, ack=True)
    deadline = time.monotonic() + timeout
    found = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"no enrollment record for {device_id!r}")
        header, _ = client.recv(timeout=remaining)
        if header.get("op") == "suback" and header.get("topic") == topic:
            if found is not None:
                return found
            raise TimeoutError(
                f"device {device_id!r} has no retained enrollment record"
            )
        if not str(header.get("topic", "")).startswith(ENROLL_TOPIC):
            continue
        info = _parse_enroll(header)
        if cache is not None:
            cache[info.device_id] = info
        if info.device_id == device_id:
            found = info             # keep reading: latest wins


def await_role(client: BrokerClient, device_id: str,
               timeout: Optional[float] = None) -> str:
    """Device side: block until the coordinator assigns this device a role.
    Subscribe BEFORE announcing to avoid a race; retained messages cover
    the reverse order too."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            raise EnrollmentTimeout(
                f"device {device_id} received no role assignment within "
                f"{timeout:.0f}s — is a coordinator running against this "
                "broker, and does its enrollment policy admit this device?"
            )
        try:
            header, _ = client.recv(timeout=remaining)
        except TimeoutError:
            raise EnrollmentTimeout(
                f"device {device_id} received no role assignment within "
                f"{timeout:.0f}s — is a coordinator running against this "
                "broker, and does its enrollment policy admit this device?"
            ) from None
        if header.get("topic") == ROLE_TOPIC + device_id:
            return header["role"]


class EnrollmentManager:
    """Coordinator side: collect announcements, select roles.

    Selection policy: the LAST enrollee — in announcement
    order — becomes the evaluator when ``want_evaluator`` and at least two
    devices enrolled; everyone else trains.
    """

    def __init__(self, client: BrokerClient, mud_policy=None,
                 device_type: Optional[str] = None):
        """``mud_policy``: optional :class:`comm.mud.MudPolicy` — the
        CoLearn enrollment gate.  Devices whose MUD profile fails the
        policy (or is malformed) are REFUSED: recorded in ``rejected``
        with the reason, never listed in ``devices()``.

        ``device_type``: restrict this manager to ONE MUD device type —
        the per-type-federation topology (one coordinator per type over
        the same broker; devices of other types are simply not-mine,
        skipped without rejection).  Implies a profile is required."""
        self._client = client
        self._client.subscribe(ENROLL_TOPIC + "#")
        self._lock = threading.Lock()
        self._devices: dict[str, DeviceInfo] = {}
        self._profiles: dict[str, object] = {}    # device_id -> MudProfile
        self._order: list[str] = []
        self._mud_policy = mud_policy
        self._device_type = device_type
        self.rejected: dict[str, str] = {}        # device_id -> reason

    def _admit(self, info: DeviceInfo) -> None:
        from colearn_federated_learning_tpu_torch.comm.mud import (
            MudError,
            MudProfile,
        )

        profile, parse_err = None, None
        if info.mud:
            try:
                profile = MudProfile.from_json(info.mud)
            except MudError as e:
                parse_err = e
        if self._mud_policy is not None:
            try:
                if parse_err is not None:
                    raise parse_err
                self._mud_policy.check(profile, info.device_id)
            except MudError as e:
                with self._lock:
                    self.rejected[info.device_id] = str(e)
                    # A previously admitted device that re-announces with
                    # a now-rejected profile is withdrawn FROM THE
                    # MANAGER: it no longer appears in devices()/
                    # profile_of, and the elastic admission path will not
                    # re-admit it.  A coordinator that already captured
                    # the device in its trainers list keeps its own copy
                    # — mid-run eviction is the coordinator's call (the
                    # straggler/eviction machinery), not the manager's.
                    self._withdraw_locked(info.device_id)
                return
        if self._device_type is not None and (
            profile is None or profile.device_type != self._device_type
        ):
            # Another type's device (or profile-less): not-mine, not a
            # rejection — a sibling per-type manager owns it.
            with self._lock:
                self._withdraw_locked(info.device_id)
            return
        with self._lock:
            self.rejected.pop(info.device_id, None)
            if info.device_id not in self._devices:
                self._order.append(info.device_id)
            self._devices[info.device_id] = info
            self._profiles[info.device_id] = profile

    def _withdraw_locked(self, device_id: str) -> None:
        """Remove every manager-side trace of ``device_id`` (call with
        ``self._lock`` held) — shared by the rejection and not-my-type
        paths so their bookkeeping can never drift."""
        if device_id in self._devices:
            del self._devices[device_id]
            self._order.remove(device_id)
            self._profiles.pop(device_id, None)

    def poll(self, duration: float) -> None:
        """Drain announcements for ``duration`` seconds."""
        deadline = time.monotonic() + duration
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            try:
                header, _ = self._client.recv(timeout=remaining)
            except (TimeoutError, OSError):
                return
            if (header.get("op") == "suback"
                    or not str(header.get("topic", "")).startswith(
                        ENROLL_TOPIC)):
                continue
            self._admit(_parse_enroll(header))

    def profile_of(self, device_id: str):
        """The admitted device's parsed MudProfile (None when it enrolled
        without one or no policy parses profiles)."""
        with self._lock:
            return self._profiles.get(device_id)

    def wait_for(self, n: int, timeout: float, poll_step: float = 0.2) -> None:
        """Poll until at least ``n`` devices enrolled (or raise)."""
        deadline = time.monotonic() + timeout
        while len(self.devices()) < n:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(self.devices())}/{n} devices enrolled"
                )
            self.poll(poll_step)

    def devices(self) -> list[DeviceInfo]:
        with self._lock:
            return [self._devices[d] for d in self._order]

    def assign_roles(self, want_evaluator: bool = True
                     ) -> tuple[list[DeviceInfo], Optional[DeviceInfo]]:
        """Pick (trainers, evaluator) and publish retained role messages."""
        devs = self.devices()
        if not devs:
            raise RuntimeError("no devices enrolled")
        evaluator = None
        trainers = devs
        if want_evaluator and len(devs) >= 2:
            evaluator = devs[-1]
            trainers = devs[:-1]
        for d in trainers:
            self._client.publish(ROLE_TOPIC + d.device_id,
                                 {"role": "trainer"}, retain=True)
        if evaluator is not None:
            self._client.publish(ROLE_TOPIC + evaluator.device_id,
                                 {"role": "evaluator"}, retain=True)
        return trainers, evaluator


def admit_late_joiners(enroll: "EnrollmentManager", broker, trainers: list,
                       evaluator, clients: dict, poll: float = 0.1) -> list:
    """Elastic membership, shared by BOTH coordinators (sync round loop and
    async pumps): poll enrollment, give every newcomer the trainer role
    (retained), open its tensor connection into ``clients`` and append it
    to ``trainers``.  Returns the admitted device ids."""
    from colearn_federated_learning_tpu_torch.comm.transport import TensorClient

    enroll.poll(poll)
    known = {d.device_id for d in trainers}
    if evaluator is not None:
        known.add(evaluator.device_id)
    admitted = []
    for d in enroll.devices():
        if d.device_id in known:
            continue
        try:
            clients[d.device_id] = TensorClient(
                d.host, d.port, timeout=protocol.CONNECT_TIMEOUT,
                ident=d.device_id)
        except OSError:
            # Announced but unreachable (died between enroll and admit):
            # skip it this poll, counted.
            protocol.count_suppressed()
            continue
        broker.publish(ROLE_TOPIC + d.device_id,
                       {"role": "trainer"}, retain=True)
        trainers.append(d)
        admitted.append(d.device_id)
    return admitted
