"""Seeded synthetic device population with on-demand shard materialization.

A fleet of a million devices cannot hold its data resident: at the
default shard shape that is ~4 GB of features alone.  Instead every
device's shard is a PURE FUNCTION of ``(spec.seed, device_id)`` — the
simulator materializes only the chunk of devices currently being
trained, and the same device always regenerates byte-identical data no
matter which chunk (or process) asks for it.

The per-device stream is a vectorized splitmix64 hash (the same
counter-based-key idea as ``utils/prng.py``, but numpy-side so a 4096-
device chunk materializes in one shot with no per-device Python loop):

- non-IID-ness: each device has a "home" class; ``label_skew`` of its
  labels come from it, the rest uniform — a pathological-partition
  analog with a smooth knob (data/partition.py has the exact protocols);
- features: class prototype + Gaussian noise, the ``data/synthetic.py``
  recipe;
- heterogeneous compute: every device belongs to a speed class
  (fast/standard/slow by population fraction) whose ``step_fraction``
  maps to the engine's per-client ``step_budget`` — slow devices run
  fewer of the static ``num_steps`` and fall out of the FedAvg weight
  exactly like the engine's stragglers (fed/local.py masking).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays."""
    with np.errstate(over="ignore"):    # mod-2^64 wraparound is the point
        z = (z + _GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def hash_u01(seed: int, stream: int, ids: np.ndarray) -> np.ndarray:
    """Deterministic uniforms in [0, 1): one independent draw per entry of
    ``ids``, keyed on ``(seed, stream, id)``.  53-bit mantissa precision;
    identical across processes and Python hash seeds (the same contract
    as faults/plan._hash_unit, vectorized)."""
    with np.errstate(over="ignore"):
        base = _mix64(np.uint64(seed % (1 << 63))
                      ^ (_GOLDEN * np.uint64(stream % (1 << 32))))
        h = _mix64(np.asarray(ids, np.uint64) * _GOLDEN + base)
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _hash_normal(seed: int, stream: int, ids: np.ndarray) -> np.ndarray:
    """Standard normals via Box-Muller on two hashed uniform streams."""
    u1 = hash_u01(seed, stream, ids)
    u2 = hash_u01(seed, stream + 1, ids)
    r = np.sqrt(-2.0 * np.log1p(-u1))           # log1p: u1=0 stays finite
    return r * np.cos(2.0 * np.pi * u2)


class SpeedClass(NamedTuple):
    """One compute-speed tier: ``fraction`` of the population runs
    ``step_fraction`` of the static local step budget."""

    name: str
    fraction: float
    step_fraction: float


DEFAULT_SPEED_CLASSES = (
    SpeedClass("fast", 0.50, 1.0),
    SpeedClass("standard", 0.35, 0.5),
    SpeedClass("slow", 0.15, 0.25),
)


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Shape of the synthetic fleet; everything derives from ``seed``."""

    num_devices: int
    num_classes: int = 10
    feature_dim: int = 32
    shard_capacity: int = 32          # padded per-device examples (static)
    min_examples: int = 8             # true count in [min, capacity]
    label_skew: float = 0.7           # P(label == home class)
    noise_scale: float = 0.3          # feature noise around the prototype
    seed: int = 0
    speed_classes: tuple = DEFAULT_SPEED_CLASSES

    def __post_init__(self):
        if self.num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        if not 1 <= self.min_examples <= self.shard_capacity:
            raise ValueError(
                f"need 1 <= min_examples <= shard_capacity, got "
                f"{self.min_examples} / {self.shard_capacity}")
        if not 0.0 <= self.label_skew <= 1.0:
            raise ValueError(f"label_skew must be in [0, 1], got "
                             f"{self.label_skew}")
        total = sum(c[1] for c in self.speed_classes)
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"speed class fractions must sum to 1, got {total}")


# Stream tags (the population's analog of utils/prng's purpose tags).
_S_PROTO = 11
_S_COUNT = 21
_S_HOME = 31
_S_LABEL = 41
_S_NOISE = 61          # consumes 2 streams (Box-Muller)
_S_SPEED = 81


class DevicePopulation:
    """Materialize any slice of the fleet on demand.

    All methods take a vector of device ids and return arrays aligned
    with it; nothing is cached per device, so memory is bounded by the
    largest chunk ever requested.
    """

    def __init__(self, spec: PopulationSpec):
        self.spec = spec
        s = spec
        # Class prototypes: the only O(classes x features) resident state.
        grid = (np.arange(s.num_classes, dtype=np.uint64)[:, None]
                * np.uint64(s.feature_dim)
                + np.arange(s.feature_dim, dtype=np.uint64)[None, :])
        self._prototypes = _hash_normal(s.seed, _S_PROTO, grid).astype(
            np.float32)
        fracs = np.array([c[2] for c in s.speed_classes], np.float64)
        self._speed_cum = np.cumsum(
            [c[1] for c in s.speed_classes])        # class boundaries
        self._speed_step_fraction = fracs

    # ------------------------------------------------------ attributes --
    def _check(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.spec.num_devices):
            raise ValueError(
                f"device ids out of range [0, {self.spec.num_devices})")
        return ids

    def counts(self, ids: np.ndarray) -> np.ndarray:
        """True shard size per device, in [min_examples, capacity]."""
        s = self.spec
        u = hash_u01(s.seed, _S_COUNT, self._check(ids))
        span = s.shard_capacity - s.min_examples + 1
        return (s.min_examples + np.floor(u * span)).astype(np.int32)

    def home_classes(self, ids: np.ndarray) -> np.ndarray:
        s = self.spec
        u = hash_u01(s.seed, _S_HOME, self._check(ids))
        return np.floor(u * s.num_classes).astype(np.int32)

    def speed_class_index(self, ids: np.ndarray) -> np.ndarray:
        """Index into ``spec.speed_classes`` per device."""
        u = hash_u01(self.spec.seed, _S_SPEED, self._check(ids))
        return np.searchsorted(self._speed_cum, u, side="right").clip(
            0, len(self.spec.speed_classes) - 1).astype(np.int32)

    def step_budgets(self, ids: np.ndarray, num_steps: int) -> np.ndarray:
        """Per-device step budget: the speed class' fraction of the static
        per-round budget, floored at one step (matching the engine's
        convention that even the slowest client makes progress)."""
        frac = self._speed_step_fraction[self.speed_class_index(ids)]
        return np.maximum(1, np.floor(frac * num_steps)).astype(np.int32)

    # ----------------------------------------------------------- shards --
    def materialize(self, ids: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(x, y, counts)`` for a chunk of devices: x is
        ``(n, capacity, feature_dim)`` float32, y ``(n, capacity)`` int32,
        counts ``(n,)`` int32 — the same padded-shard layout as
        ``data/sharding.ClientShards``, rows past ``count`` zeroed."""
        s = self.spec
        ids = self._check(ids)
        n = ids.shape[0]
        cap, fdim = s.shard_capacity, s.feature_dim
        counts = self.counts(ids)
        home = self.home_classes(ids)

        # Per-(device, slot) keys: device_id * capacity + slot is unique
        # within a stream, so the same device regenerates the same rows
        # in any chunking.
        slot_ids = (ids[:, None].astype(np.uint64) * np.uint64(cap)
                    + np.arange(cap, dtype=np.uint64)[None, :])
        u_skew = hash_u01(s.seed, _S_LABEL, slot_ids)
        u_cls = hash_u01(s.seed, _S_LABEL + 1, slot_ids)
        uniform = np.floor(u_cls * s.num_classes).astype(np.int32)
        y = np.where(u_skew < s.label_skew, home[:, None], uniform)

        feat_ids = (slot_ids[..., None] * np.uint64(fdim)
                    + np.arange(fdim, dtype=np.uint64)[None, None, :])
        noise = _hash_normal(s.seed, _S_NOISE, feat_ids)
        x = (self._prototypes[y] + s.noise_scale * noise).astype(np.float32)

        valid = (np.arange(cap, dtype=np.int32)[None, :] < counts[:, None])
        x *= valid[..., None]
        y = np.where(valid, y, 0).astype(np.int32)
        return x, y, counts

    def example_batch(self, batch_size: int) -> np.ndarray:
        """A representative feature batch for model initialization."""
        x, _, _ = self.materialize(np.zeros((1,), np.int64))
        reps = int(np.ceil(batch_size / x.shape[1]))
        flat = np.tile(x[0], (reps, 1))[:batch_size]
        return flat
