"""Seeded-EWMA arrival-rate estimation for the buffered-async plane.

The async coordinator folds a buffer of K updates whenever K arrive; the
fleet simulator does the same on a virtual clock.  Both planes previously
*reacted* to arrivals without measuring them, which left ROADMAP's
"adaptive buffer size K driven by the observed arrival rate" unbuildable:
there was no observed arrival rate.  This module is that observation.

Design points:

- **Clock-agnostic.** ``observe(device_id, now=t)`` takes the caller's
  timestamp in the caller's units — wall seconds for the coordinator,
  virtual sim-minutes for fleetsim — and every rate it reports is in
  arrivals per that same unit.  Nothing here reads a clock, which keeps
  fleetsim runs deterministic and tests hermetic.
- **Seeded EWMA.** The estimator smooths *inter-arrival gaps*, not
  counts-per-tick, so it needs no bucketing interval.  The first gap a
  stream sees seeds the EWMA directly instead of decaying up from zero —
  a zero-initialised EWMA under-reports rate for ~1/alpha observations,
  which is exactly the warm-up window an auto-K controller must not
  spend mis-sized.
- **Fleet + per-device.** The fleet stream drives buffer sizing; the
  per-device streams feed straggler attribution (a device whose arrival
  rate collapses is stalling before it ever trips a deadline).

``recommend_buffer`` is the control half: given a target fold cadence it
returns the K that would fold at that cadence under the current fleet
rate (K = rate x target interval, clamped to the caller's bounds).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class _EwmaRate:
    """EWMA over inter-arrival gaps for one stream.  ``rate`` is
    1/gap — arrivals per time unit — or 0.0 before two observations."""

    __slots__ = ("alpha", "last_t", "gap", "count")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.last_t: Optional[float] = None
        self.gap: Optional[float] = None
        self.count = 0

    def observe(self, now: float) -> None:
        self.count += 1
        if self.last_t is not None:
            g = max(now - self.last_t, 1e-9)
            # First gap seeds the EWMA; later gaps blend in.
            self.gap = g if self.gap is None else (
                self.alpha * g + (1.0 - self.alpha) * self.gap)
        self.last_t = now

    @property
    def rate(self) -> float:
        return 1.0 / self.gap if self.gap else 0.0


class ArrivalEstimator:
    """Fleet-wide and per-device arrival-rate estimator.

    Thread-safe: the coordinator's dispatcher pumps observe from many
    threads while ``run_aggregation`` reads the fleet rate.
    """

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._fleet = _EwmaRate(alpha)
        self._devices: Dict[str, _EwmaRate] = {}
        self._lock = threading.Lock()

    def observe(self, device_id: Optional[str] = None, *,
                now: float) -> None:
        """Record one arrival at time ``now`` (caller's clock + units)."""
        with self._lock:
            self._fleet.observe(now)
            if device_id is not None:
                dev = self._devices.get(device_id)
                if dev is None:
                    dev = self._devices[device_id] = _EwmaRate(self.alpha)
                dev.observe(now)

    @property
    def count(self) -> int:
        with self._lock:
            return self._fleet.count

    def rate(self) -> float:
        """Fleet arrivals per time unit (0.0 until two arrivals)."""
        with self._lock:
            return self._fleet.rate

    def device_rate(self, device_id: str) -> float:
        with self._lock:
            dev = self._devices.get(device_id)
            return dev.rate if dev is not None else 0.0

    def device_rates(self) -> Dict[str, float]:
        with self._lock:
            return {d: e.rate for d, e in self._devices.items()}

    def group_rate(self, device_ids) -> float:
        """Summed per-device rate over one slice of the fleet — the
        arrival rate an aggregator owning exactly ``device_ids`` would
        see.  Devices the estimator has not warmed up on contribute 0.0
        (same cold semantics as :meth:`device_rate`)."""
        with self._lock:
            return sum(
                self._devices[str(d)].rate for d in device_ids
                if str(d) in self._devices)

    def recommend_buffer(self, target_interval: float, *, lo: int = 1,
                         hi: int = 1 << 30,
                         current: Optional[int] = None) -> int:
        """K that folds once per ``target_interval`` at the current fleet
        rate, clamped to [lo, hi].  Falls back to ``current`` (or ``lo``)
        while the estimator is still cold."""
        r = self.rate()
        if r <= 0.0:
            k = current if current is not None else lo
        else:
            k = int(round(r * target_interval))
        return max(lo, min(hi, k))

    def export_gauges(self, reg, name: str, *, top: int = 8) -> None:
        """Set the fleet gauge ``name`` and per-device children
        ``name{device=...}`` for the ``top`` fastest devices.  Labeled
        gauges do not roll up in the registry, so the fleet value is a
        separately-set unlabeled gauge."""
        with self._lock:
            fleet = self._fleet.rate
            rates = {d: e.rate for d, e in self._devices.items()}
        # Callers pass a catalog-declared literal (the coordinator's
        # async.arrival_rate_per_s); this helper just fans it out.
        reg.gauge(name).set(fleet)  # colearn: noqa(CL005): callers pass a catalog-declared literal
        for dev, r in sorted(rates.items(), key=lambda kv: -kv[1])[:top]:
            reg.gauge(  # colearn: noqa(CL005): same catalog-declared name, fanned out per device
                name, labels={"device": str(dev)}).set(r)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rate": self._fleet.rate,
                "count": self._fleet.count,
                "devices": {d: e.rate for d, e in self._devices.items()},
            }
