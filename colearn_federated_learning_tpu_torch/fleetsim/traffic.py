"""Arrival-process availability model driving fleet cohort sampling.

Real fleets are never all online: devices check in following their
owners' days (CoLearn's MUD-gated IoT fleets announce when powered;
CLIP/DisAgg in PAPERS.md study exactly this straggler/availability
regime).  The model here is the standard non-homogeneous Poisson
arrival process:

- each device has an arrival rate ``base_rate`` (expected check-ins per
  simulated hour) modulated by a diurnal sinusoid with a per-device
  phase (its timezone / usage habit, hashed from the device id);
- a device is AVAILABLE for a round iff it has >= 1 arrival inside the
  round's simulated window: ``p = 1 - exp(-rate * window)``;
- availability draws are keyed on ``(seed, device, round)`` with the
  same vectorized hash as the population, so a schedule replays
  byte-identically — the FaultPlan determinism contract extended to
  traffic.

``sample_cohort`` ranks the currently-available devices by a per-round
hashed score and takes the first ``cohort_size`` — uniform sampling
without replacement among available devices, the host-side analog of
the engine's ``_rank_cohort``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from colearn_federated_learning_tpu_torch.fleetsim.population import hash_u01

_S_PHASE = 101
_S_ARRIVE = 111
_S_RANK = 131

_MINUTES_PER_DAY = 24.0 * 60.0


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Arrival-process parameters; everything derives from ``seed``."""

    base_rate: float = 2.0            # mean check-ins per device-hour
    diurnal_amplitude: float = 0.8    # 0 = flat; 1 = full day/night swing
    phase_spread: float = 0.25        # per-device phase scatter, in days:
                                      # 0 = one timezone (full fleet-level
                                      # rhythm); 1 = uniform phases (the
                                      # fleet mean flattens out)
    round_minutes: float = 10.0       # simulated wall time per round
    seed: int = 0

    def __post_init__(self):
        if self.base_rate < 0:
            raise ValueError(f"base_rate must be >= 0, got {self.base_rate}")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1], got "
                             f"{self.diurnal_amplitude}")
        if not 0.0 <= self.phase_spread <= 1.0:
            raise ValueError("phase_spread must be in [0, 1], got "
                             f"{self.phase_spread}")
        if self.round_minutes <= 0:
            raise ValueError("round_minutes must be > 0, got "
                             f"{self.round_minutes}")


class TrafficModel:
    """Deterministic availability + cohort sampling over ``num_devices``."""

    def __init__(self, spec: TrafficSpec, num_devices: int):
        if num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        self.spec = spec
        self.num_devices = int(num_devices)

    # ----------------------------------------------------------- rates --
    def availability_probability(self, round_idx: int,
                                 ids: np.ndarray) -> np.ndarray:
        """P(device has >= 1 arrival in this round's window)."""
        s = self.spec
        ids = np.asarray(ids, np.int64)
        t_min = round_idx * s.round_minutes
        # Per-device phase (its usage habit), scattered over phase_spread
        # of a day: fleets cluster in timezones, so the FLEET-level
        # rhythm survives unless spread -> 1 washes it out.
        phase = s.phase_spread * hash_u01(s.seed, _S_PHASE, ids)
        diurnal = 1.0 + s.diurnal_amplitude * np.sin(
            2.0 * np.pi * (t_min / _MINUTES_PER_DAY + phase))
        rate_per_min = s.base_rate / 60.0 * diurnal
        return -np.expm1(-rate_per_min * s.round_minutes)

    def available_mask(self, round_idx: int,
                       ids: np.ndarray | None = None) -> np.ndarray:
        """Boolean availability of ``ids`` (default: the whole fleet) for
        one round — deterministic in ``(seed, device, round)``."""
        if ids is None:
            ids = np.arange(self.num_devices, dtype=np.int64)
        ids = np.asarray(ids, np.int64)
        p = self.availability_probability(round_idx, ids)
        u = hash_u01(self.spec.seed, _S_ARRIVE + 7919 * (round_idx + 1), ids)
        return u < p

    def expected_available(self, round_idx: int) -> float:
        """Fleet-mean availability probability (capacity-planning view)."""
        ids = np.arange(self.num_devices, dtype=np.int64)
        return float(self.availability_probability(round_idx, ids).mean())

    # --------------------------------------------------------- sampling --
    def sample_cohort(self, round_idx: int, cohort_size: int) -> np.ndarray:
        """Uniform sample WITHOUT replacement among currently-available
        devices: rank by a per-(round, device) hashed score, take the
        first ``cohort_size``.  Returns fewer ids when fewer devices are
        available (the realized cohort — callers record the shortfall)."""
        avail = np.flatnonzero(self.available_mask(round_idx))
        if avail.size <= cohort_size:
            return avail.astype(np.int64)
        scores = hash_u01(self.spec.seed, _S_RANK + 7919 * (round_idx + 1),
                          avail)
        take = np.argpartition(scores, cohort_size)[:cohort_size]
        return np.sort(avail[take]).astype(np.int64)
