"""Per-device-type federations: the CoLearn deployment topology (the
counterpart of the JAX package's ``comm/per_type.py``).

A device's MUD identity decides WHICH federation it joins: cameras train
the camera model, bulbs the bulb model, since one global model across
device classes would smear their distinct "normal" traffic together.

1. Device types are discovered from the retained enrollment records
   (every worker announces its RFC 8520 profile, ``comm/mud.py``).
2. One :class:`~.coordinator.FederatedCoordinator` per type, each
   restricted to ITS type (other types' devices are not its own, not
   rejections), each training its own global model on ``device``.
3. The federations run in threads over the shared broker, so a slow
   device class does not stall the others.  A type that fails is recorded
   in ``errors`` and the others run on.

``coordinate --per-type`` is the command-line entry.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from colearn_federated_learning_tpu_torch.comm import protocol
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    FederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.enrollment import (
    EnrollmentManager)
from colearn_federated_learning_tpu_torch.comm.mud import (
    group_by_device_type)
from colearn_federated_learning_tpu_torch.utils.config import (
    ExperimentConfig)


def discover_types(broker_host: str, broker_port: int, min_devices: int,
                   timeout: float, mud_policy=None) -> dict[str, list]:
    """``{device_type: [DeviceInfo, ...]}`` from the retained enrollment
    records, once at least ``min_devices`` admitted devices are visible.
    Profile-less devices group under ``""``."""
    client = BrokerClient(broker_host, broker_port,
                          timeout=protocol.CONNECT_TIMEOUT)
    try:
        enroll = EnrollmentManager(client, mud_policy=mud_policy)
        enroll.wait_for(min_devices, timeout)
        return group_by_device_type(
            [(d, enroll.profile_of(d.device_id)) for d in enroll.devices()])
    finally:
        client.close()


class PerTypeFederation:
    """One federation per discovered MUD device type (see the module
    docstring); every coordinator's server state lives on ``device``."""

    def __init__(self, config: ExperimentConfig, broker_host: str,
                 broker_port: int, round_timeout: float = 60.0,
                 mud_policy=None, min_devices_per_type: int = 2,
                 device=None):
        self.config = config
        self.broker = (broker_host, broker_port)
        self.round_timeout = round_timeout
        self.mud_policy = mud_policy
        self.min_per_type = min_devices_per_type
        self.device = device
        self.coordinators: dict[str, FederatedCoordinator] = {}
        self.skipped: dict[str, int] = {}     # type -> too-few device count
        self.histories: dict[str, list] = {}
        self.errors: dict[str, str] = {}

    def run(self, min_devices: int, enroll_timeout: float = 60.0,
            rounds: Optional[int] = None, want_evaluator: bool = False,
            log_fn=None) -> dict[str, list]:
        """Discover the types, then train every type's federation to its
        end (threads over the shared broker).  Returns the per-type round
        histories; types with fewer than ``min_devices_per_type`` devices,
        and the untyped group, are skipped and recorded in ``skipped``;
        ``log_fn(type, record)`` sees every record."""
        groups = discover_types(*self.broker, min_devices=min_devices,
                                timeout=enroll_timeout,
                                mud_policy=self.mud_policy)
        group_sizes: dict[str, int] = {}
        for dtype, devs in sorted(groups.items()):
            if not dtype or len(devs) < self.min_per_type:
                self.skipped[dtype] = len(devs)
                continue
            group_sizes[dtype] = len(devs)
            cfg = self.config.replace(run=dataclasses.replace(
                self.config.run, name=f"{self.config.run.name}_{dtype}"))
            self.coordinators[dtype] = FederatedCoordinator(
                cfg, *self.broker, round_timeout=self.round_timeout,
                want_evaluator=want_evaluator, mud_policy=self.mud_policy,
                device_type=dtype, device=self.device)

        def train(dtype: str, coord: FederatedCoordinator) -> None:
            try:
                # The whole discovered group, not the minimum: a device
                # still enrolling must not be left without a role.
                coord.enroll(min_devices=group_sizes[dtype],
                             timeout=enroll_timeout)
                self.histories[dtype] = coord.fit(
                    rounds=rounds,
                    log_fn=(lambda rec, t=dtype: log_fn(t, rec))
                    if log_fn else None)
            except Exception as e:  # noqa: BLE001 — per-type isolation:
                # one failing device class must not stop the others; the
                # caller reads ``errors``.
                self.errors[dtype] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=train, args=(t, c), daemon=True,
                                    name=f"federate-{t}")
                   for t, c in self.coordinators.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return self.histories

    def close(self) -> None:
        for coord in self.coordinators.values():
            coord.close()
