"""Deterministic fault schedules for the federation planes: a copy of the
JAX package's ``faults/plan.py`` (pure Python), so the same plan file and
seed give the same decisions in both packages.

A :class:`FaultPlan` is a seeded list of :class:`FaultSpec` entries keyed
by ``(device_id, round, op)`` and, for the file and hierarchical planes,
``hop`` (the exchange leg).  Matching is bookkeeping only: ``inject``
turns matches into transport behaviour and ``fileplane`` into
exchange-file behaviour.  The same plan and seed fire the same faults at
the same keys on every run.

Comm-plane kinds (``inject``, at the transport seams): ``drop_request``,
``delay``, ``corrupt_payload``, ``crash_worker``, ``flap_reconnect``.  The
``op`` key matches the request header's, so secure rounds have two more
drop points: ``share_setup`` (pruned before training) and ``unmask``
(silent during recovery).  File and hierarchical kinds (``fileplane``,
keyed ``(silo|group, round, hop)``): ``truncate_file``, ``stale_round``,
``drop_silo``.  Checkpoint kinds (``fileplane``'s ``ckpt_*`` hooks in
``ckpt/streaming.py`` saves, keyed ``(shard, generation, op)``):
``torn_shard`` (a committed shard file cut to half its bytes),
``stale_manifest`` (the manifest write skipped, so the generation stays
uncommitted) and ``slow_io`` (the write sleeps ``ms`` first).

JSON surface (``--fault-plan plan.json``)::

    {"seed": 7, "faults": [
        {"kind": "delay", "device_id": "1", "round": 2, "op": "train",
         "ms": 250},
        {"kind": "corrupt_payload", "device_id": "2", "round": 3},
        {"kind": "drop_silo", "device_id": "g1", "round": 2, "hop": "sync"}
    ]}
"""

from __future__ import annotations

import dataclasses
import json
import threading
import zlib
from typing import Optional

KINDS = ("drop_request", "delay", "corrupt_payload", "crash_worker",
         "flap_reconnect", "truncate_file", "stale_round", "drop_silo",
         "torn_shard", "stale_manifest", "slow_io")

FILE_KINDS = ("truncate_file", "stale_round", "drop_silo")

CKPT_KINDS = ("torn_shard", "stale_manifest", "slow_io")

ANY = "*"          # wildcard device_id / op
ANY_ROUND = -1     # wildcard round


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``count`` bounds how many times the spec fires (0 = unlimited);
    ``probability`` gates each candidate firing through a deterministic
    per-key hash of the plan seed, so sub-1.0 rates are reproducible.
    ``site`` selects which transport end applies it (faults fire on the
    device's server side by default — that is where ``device_id`` is
    authoritative).  ``hop`` keys file/hierarchical-plane faults to one
    exchange leg (file plane: ``update``; hierarchical: ``sync`` edge→
    cloud, ``seed`` cloud→edge); it is ignored by the comm plane."""

    kind: str
    device_id: str = ANY
    round: int = ANY_ROUND
    op: str = ANY
    ms: float = 0.0                  # delay duration
    count: int = 1                   # max firings; 0 = unlimited
    probability: float = 1.0
    site: str = "server"             # server | client
    hop: str = ANY                   # file/hier exchange leg

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.site not in ("server", "client"):
            raise ValueError(f"fault site must be server|client, "
                             f"got {self.site!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"probability must be in [0, 1], got {self.probability}")
        if self.ms < 0 or self.count < 0:
            raise ValueError("ms and count must be >= 0")

    def matches(self, device_id: str, round_idx: Optional[int],
                op: str, hop: str = ANY) -> bool:
        if self.device_id != ANY and self.device_id != str(device_id):
            return False
        if self.round != ANY_ROUND and (round_idx is None
                                        or int(round_idx) != self.round):
            return False
        if self.op != ANY and self.op != op:
            return False
        if self.hop != ANY and self.hop != hop:
            return False
        return True


def _hash_unit(seed: int, key: str) -> float:
    """Deterministic uniform in [0, 1) from (seed, key) — crc32-based so
    the schedule is identical across processes and Python hash seeds."""
    h = zlib.crc32(f"{seed}:{key}".encode())
    return h / float(1 << 32)


class FaultPlan:
    """Seeded, deterministic fault schedule with firing bookkeeping."""

    def __init__(self, faults: list[FaultSpec] = (), seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self._fired = [0] * len(self.faults)
        self._lock = threading.Lock()

    # ---------------------------------------------------------- config --
    @classmethod
    def from_json(cls, text: str, seed: Optional[int] = None) -> "FaultPlan":
        doc = json.loads(text)
        specs = [FaultSpec(**f) for f in doc.get("faults", [])]
        return cls(specs, seed=doc.get("seed", 0) if seed is None else seed)

    @classmethod
    def load(cls, path: str, seed: Optional[int] = None) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read(), seed=seed)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }, indent=2)

    # ---------------------------------------------------------- firing --
    def match(self, device_id: str, round_idx: Optional[int], op: str,
              kinds: tuple = KINDS, site: str = "server", hop: str = ANY
              ) -> list[FaultSpec]:
        """The specs that FIRE for this ``(device_id, round, op[, hop])``
        event, consuming one firing from each returned spec's ``count``
        budget.  Deterministic: the probability gate hashes the plan seed
        with the event key and the spec index, never a live RNG.  The hop
        joins the hash key only when given, so comm-plane schedules are
        bit-identical to the pre-hop format."""
        out = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.site != site or f.kind not in kinds:
                    continue
                if f.count and self._fired[i] >= f.count:
                    continue
                if not f.matches(device_id, round_idx, op, hop):
                    continue
                if f.probability < 1.0:
                    key = f"{device_id}:{round_idx}:{op}:{i}"
                    if hop != ANY:
                        key = f"{device_id}:{round_idx}:{op}:{hop}:{i}"
                    if _hash_unit(self.seed, key) >= f.probability:
                        continue
                self._fired[i] += 1
                out.append(f)
        return out

    @property
    def fired(self) -> dict[int, int]:
        """``{spec index: times fired}`` for specs that fired at least
        once — the soak report's injection ledger."""
        with self._lock:
            return {i: n for i, n in enumerate(self._fired) if n}

    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired)
