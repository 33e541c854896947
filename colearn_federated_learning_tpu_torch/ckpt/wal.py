"""JSON round write-ahead log for coordinator crash recovery: the JAX
package's ``ckpt/wal.py`` (no torch in it), so either package reads the
other's logs.

The checkpoint (ckpt/manager.py or ckpt/streaming.py) carries the
heavyweight server state; this WAL carries the lightweight durable
record of WHAT each committed round did — the round counter, the
accepted-update manifest, and the round record — one fsynced JSON line
per round.  Together they
let a restarted coordinator prove which rounds are committed: a WAL
entry past the latest checkpoint step is an uncommitted round whose
server-state delta died with the process, and resume discards it.

The format is deliberately boring: append-only JSONL, ``fsync`` after
every append, torn final line tolerated on load (the log itself must
survive the SIGKILLs it exists to describe).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics


class RoundWal:
    """Append-only fsynced JSONL round log under the checkpoint dir."""

    FILENAME = "round_wal.jsonl"

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.FILENAME)
        self._f = None

    # ----------------------------------------------------------- write --
    def _handle(self):
        if self._f is None:
            self._f = open(self.path, "a", encoding="utf-8")
        return self._f

    def append(self, entry: dict) -> None:
        """Durably append one round entry (fsync before returning)."""
        f = self._handle()
        f.write(json.dumps(entry, separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())
        _metrics.get_registry().counter("ckpt.wal_appends_total").inc()

    # ------------------------------------------------------------ read --
    def load(self) -> list[dict]:
        """All decodable entries.  A torn final line — the append that was
        in flight when the process died — is dropped and counted
        (``ckpt.wal_torn_tail_total``); a torn line anywhere else is
        corruption and raises."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        out: list[dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    _metrics.get_registry().counter(
                        "ckpt.wal_torn_tail_total").inc()
                    break
                raise ValueError(
                    f"corrupt WAL entry at {self.path}:{i + 1}")
        return out

    def rewind(self, num_entries: int) -> None:
        """Atomically truncate the log to its first ``num_entries``
        entries — how resume discards uncommitted-tail rounds."""
        entries = self.load()[:num_entries]
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for e in entries:
                f.write(json.dumps(e, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self.close()
        os.replace(tmp, self.path)

    # ----------------------------------------------------------- admin --
    def committed_rounds(self) -> Optional[int]:
        """Number of logged rounds, or None when the log doesn't exist."""
        if not os.path.exists(self.path):
            return None
        return len(self.load())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class EnrollmentLedger(RoundWal):
    """Durable admission record: WHO the coordinator ever admitted, and
    under WHICH identity public key.

    Broker-retained announcements are soft state — they die with the
    broker, replay after it restarts, and anyone who can publish can
    forge one.  This ledger is the hard state a resumed coordinator
    trusts instead: one fsynced JSON line per admission (device_id,
    address, identity pubkey, wall time), latest line per device wins.
    ``coordinator.verify_resumed_devices`` readmits a device only when
    it is in this ledger AND answers a nonce challenge under the
    recorded key.  Reuses the RoundWal machinery wholesale — append-only
    JSONL, fsync per append, torn final line tolerated on load.
    """

    FILENAME = "enroll_ledger.jsonl"

    def append(self, entry: dict) -> None:
        f = self._handle()
        f.write(json.dumps(entry, separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())
        _metrics.get_registry().counter(
            "comm.enroll_ledger_appends_total").inc()

    def admit(self, dev) -> None:
        """Record one admission (DeviceInfo or any object with
        device_id/host/port/pubkey attributes)."""
        import time

        self.append({
            "device_id": str(dev.device_id),
            "host": str(dev.host),
            "port": int(dev.port),
            "pubkey": str(getattr(dev, "pubkey", "") or ""),
            "ts": time.time(),
        })

    def revoke(self, device_id: str) -> None:
        """Durably retract a device's admission — the challenge-on-resume
        reject path.  Latest-line-wins turns the retraction into absence
        from :meth:`devices`, so an admission appended from a replayed or
        forged announcement (the resumed enrollment records devices
        before the challenge can vet them) cannot satisfy a LATER resume
        either.  A genuine re-admission after the revocation supersedes
        it — revocation is an append, not a ban."""
        import time

        self.append({"device_id": str(device_id), "revoked": True,
                     "ts": time.time()})

    def devices(self) -> dict:
        """``device_id -> latest admission record``.  Re-announcing with
        a fresh key supersedes the old binding (last line wins), so key
        rotation is an append, not an edit; a revocation line erases the
        device until its next admission."""
        out: dict[str, dict] = {}
        for entry in self.load():
            did = str(entry.get("device_id", ""))
            if not did:
                continue
            if entry.get("revoked"):
                out.pop(did, None)
            else:
                out[did] = entry
        return out
