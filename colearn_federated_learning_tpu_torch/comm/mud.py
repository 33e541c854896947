"""RFC 8520 (MUD) device profiles for enrollment gating: a copy of the JAX
package's ``comm/mud.py``, which is pure Python.

CoLearn combines Manufacturer Usage Description profiles with federated
learning: a device presents its MUD profile, the network derives what the
device is (manufacturer, model, type), and the federation uses that
identity to decide who may join and which federation.

- :class:`MudProfile`: the subset of an RFC 8520 MUD file the federation
  reads (``mud-url``, ``mud-version``, ``is-supported``, ``systeminfo``,
  ``mfg-name``/``model-name``, ``cache-validity``), parsed from the
  ``ietf-mud:mud`` container with loud errors for malformed files.
- :class:`MudPolicy`: the coordinator's gate (require a profile,
  allowlist device types, refuse unsupported devices), evaluated at
  enrollment (``comm/enrollment.py``).
- :func:`group_by_device_type`: enrolled devices per type.

Profiles travel as JSON on the retained enrollment record, not fetched
from the manufacturer's URL; signature verification (RFC 8520 section 13)
is the MUD manager's job and out of scope.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


class MudError(ValueError):
    """Malformed or policy-rejected MUD profile."""


@dataclasses.dataclass(frozen=True)
class MudProfile:
    mud_url: str
    mud_version: int = 1
    is_supported: bool = True
    systeminfo: str = ""
    mfg_name: str = ""
    model_name: str = ""
    device_type: str = ""          # CoLearn-level classification
    cache_validity_hours: int = 48

    @classmethod
    def from_json(cls, text: str) -> "MudProfile":
        """Parse the ``ietf-mud:mud`` container of an RFC 8520 file."""
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise MudError(f"MUD profile is not valid JSON: {e}") from None
        container = doc.get("ietf-mud:mud")
        if not isinstance(container, dict):
            raise MudError(
                "MUD profile lacks the 'ietf-mud:mud' container "
                "(RFC 8520 section 2)"
            )
        url = container.get("mud-url", "")
        if not isinstance(url, str) or not url.startswith("https://"):
            # RFC 8520 section 3.3: mud-url MUST use the https scheme.
            raise MudError(f"mud-url must be an https URL, got {url!r}")
        version = container.get("mud-version", 1)
        if version != 1:
            raise MudError(f"unsupported mud-version {version!r}")
        try:
            return cls(
                mud_url=url,
                mud_version=int(version),
                is_supported=bool(container.get("is-supported", True)),
                systeminfo=str(container.get("systeminfo", "")),
                mfg_name=str(container.get("mfg-name", "")),
                model_name=str(container.get("model-name", "")),
                device_type=str(container.get(
                    "colearn:device-type",
                    container.get("model-name", ""))),
                cache_validity_hours=int(container.get("cache-validity", 48)),
            )
        except (TypeError, ValueError) as e:
            # Wrong-typed leaf values (e.g. cache-validity: "48h") must
            # surface as MudError — anything else would escape the
            # enrollment loop's handler and crash the coordinator on one
            # malformed enrollee.
            raise MudError(f"malformed MUD field: {e}") from None

    def to_json(self) -> str:
        return json.dumps({"ietf-mud:mud": {
            "mud-version": self.mud_version,
            "mud-url": self.mud_url,
            "is-supported": self.is_supported,
            "systeminfo": self.systeminfo,
            "mfg-name": self.mfg_name,
            "model-name": self.model_name,
            "colearn:device-type": self.device_type,
            "cache-validity": self.cache_validity_hours,
        }})


@dataclasses.dataclass(frozen=True)
class MudPolicy:
    """Coordinator-side enrollment gate.

    - ``require_profile``: devices without a MUD profile are refused.
    - ``allowed_types``: non-empty → only these device types enroll.
    - ``require_supported``: refuse devices whose manufacturer no longer
      supports them (RFC 8520 ``is-supported`` false — exactly the
      stale-firmware population an anomaly-detection federation should
      not learn 'normal' from).
    """

    require_profile: bool = False
    allowed_types: tuple[str, ...] = ()
    require_supported: bool = True

    def check(self, profile: Optional[MudProfile],
              device_id: str = "?") -> None:
        """Raise :class:`MudError` when the device must be refused."""
        if profile is None:
            # A type allowlist implies the profile is required: otherwise
            # any device could bypass the gate by simply withholding its
            # profile.
            if self.require_profile or self.allowed_types:
                raise MudError(
                    f"device {device_id}: enrollment requires a MUD "
                    "profile and none was presented"
                )
            return
        if self.require_supported and not profile.is_supported:
            raise MudError(
                f"device {device_id}: manufacturer marked this device "
                "unsupported (is-supported=false)"
            )
        if self.allowed_types and profile.device_type not in self.allowed_types:
            raise MudError(
                f"device {device_id}: device type "
                f"{profile.device_type!r} is not in the allowed set "
                f"{sorted(self.allowed_types)}"
            )


def group_by_device_type(devices_with_profiles) -> dict[str, list]:
    """``{device_type: [DeviceInfo, ...]}`` over (info, profile) pairs —
    the per-type topology CoLearn trains one anomaly model per device
    class over.  Profile-less devices group under ``""``."""
    groups: dict[str, list] = {}
    for info, profile in devices_with_profiles:
        key = profile.device_type if profile is not None else ""
        groups.setdefault(key, []).append(info)
    return groups
